"""The benchmark of ``torchmetrics_tpu_torch`` on one NVIDIA H100.

Run one cell from the root of a checkout::

    python3 portbench/run.py --workload imagenet1k_val.binned --seed 7 --seconds 30 --trace 0

Everything that belongs to one cell, configuration, traffic mix, reference or
metric sits in a file of its own, found by the name that ``BENCHMARK.json``
gives it:

- ``workloads/<cell>.json``: the cell's configuration and mix, its input pool,
  how many epochs a traced run profiles, and the limits of its comparison;
- ``configs/<config>.json``: the deployment's sizes and the data it scores;
- ``traffic/<mix>.json``: the collection's members, the form of the
  predictions, and the bytes the metric definitions need;
- ``reference/<name>.py``: the plain PyTorch definition of one metric;
- ``metrics/<metric>.py``: the reader of one metric.

Nothing here imports JAX or the JAX package, and the references import
nothing of the program.
"""
