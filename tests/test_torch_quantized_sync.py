"""The port's quantized all-reduce against the JAX package's, on the CPU.

The pure route runs over a real 4-rank gloo group (one spawn of four
processes for every case); the JAX side runs the same inputs through
``jax.vmap`` over a named axis, as the JAX package's own tests do. Held
bitwise: ``quantize_chunks``'s payloads and scales, and the all-reduce's
results and error-feedback residuals (the shared scales, the integer sums
and the requantized shards are the same numbers in both packages; the
port reduces the integers in int32, which neither NCCL nor gloo refuses).
The tolerances are the JAX tests' own (inputs in [-1, 1): 0.05 at 8 bits,
1e-3 at 16), and the eager ``Metric.sync`` route's error feedback is held
as there.
"""
import datetime
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from torchmetrics_tpu.parallel import strategies as JS
from torchmetrics_tpu.parallel import sync as JSYNC
from torchmetrics_tpu.parallel.reduction import Reduction as JReduction

import torchmetrics_tpu_torch as P
from torchmetrics_tpu_torch.parallel import FakeSync, Reduction, SyncBackend, SyncPolicy, reset_wire_stats, wire_stats
from torchmetrics_tpu_torch.parallel.strategies import dequantize_chunks, quantize_chunks, quantized_allreduce
from torchmetrics_tpu_torch.parallel.sync import reduce_state_in_graph

WORLD = 4
DEADLINE_S = 120


def _uniform(shape, seed):
    return np.random.RandomState(seed).uniform(-1.0, 1.0, size=shape).astype(np.float32)


def _vmap_world(fn, *stacked):
    return jax.vmap(fn, axis_name="dp")(*stacked)


# ---------------------------------------------------------------------------
# the chunk quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_chunks_bitwise_jax(bits):
    x = _uniform((1000,), seed=bits) * np.float32(37.5)
    x[::97] = 0.0
    x[200:264] = 0.0  # an all-zero chunk: scale 0
    q, scales, pad = quantize_chunks(torch.from_numpy(x), bits, 64)
    jq, jscales, jpad = JS.quantize_chunks(jnp.asarray(x), bits, 64)
    assert pad == jpad == 24 and q.dtype == (torch.int8 if bits == 8 else torch.int16)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(jscales))
    np.testing.assert_array_equal(dequantize_chunks(q, scales, torch.float32).numpy(),
                                  np.asarray(JS.dequantize_chunks(jq, jscales, jnp.float32)))


def test_quantize_dequantize_roundtrip_and_zero_chunks():
    x = np.concatenate([_uniform((64,), seed=3), np.zeros(32, np.float32)])
    q, scales, pad = quantize_chunks(torch.from_numpy(x), 8, 32)
    assert q.dtype == torch.int8 and pad == 0
    dq = dequantize_chunks(q, scales, torch.float32).numpy()
    np.testing.assert_allclose(dq, x, atol=1.0 / (2 * 127))
    np.testing.assert_array_equal(dq[64:], 0.0)  # scale-0 chunks are exact


# ---------------------------------------------------------------------------
# the pure route over four gloo ranks
# ---------------------------------------------------------------------------

TOLERANCE_CASES = {8: (512, 64), 16: (512, 64)}  # bits: (elements, chunk)


def _rank_cases(rank):
    out = {}
    for bits, (n, chunk) in TOLERANCE_CASES.items():
        pol = SyncPolicy(quantize_bits=bits, quantize_chunk=chunk, gather="all_gather")
        x = torch.from_numpy(_uniform((WORLD, n), seed=bits)[rank])
        out[f"tol{bits}"] = quantized_allreduce(x, policy=pol)[0]
    pol = SyncPolicy(quantize_bits=16, quantize_chunk=64, gather="all_gather")
    out["mean"] = quantized_allreduce(torch.from_numpy(_uniform((WORLD, 256), seed=7)[rank]), mean=True, policy=pol)[0]
    pol = SyncPolicy(quantize_bits=8, quantize_chunk=32, gather="all_gather")
    x, r = _uniform((WORLD, 128), seed=11)[rank], _uniform((WORLD, 128), seed=12)[rank] * np.float32(0.01)
    out["residual"] = quantized_allreduce(torch.from_numpy(x), policy=pol, residual=torch.from_numpy(r))
    # integer states are never quantized, whatever knob is armed
    armed = SyncPolicy(quantize_bits=8, quantize_threshold=16, reduce_scatter_threshold=16, gather="all_gather")
    ints = np.random.RandomState(4).randint(-(10 ** 6), 10 ** 6, size=(WORLD, 64)).astype(np.int32)
    out["ints"] = reduce_state_in_graph({"cnt": torch.from_numpy(ints[rank])}, {"cnt": Reduction.SUM},
                                        policy=armed)["cnt"]
    # the route is picked for a large float SUM: pmax, reduce-scatter, two gathers
    pol = SyncPolicy(quantize_bits=8, quantize_threshold=64, quantize_chunk=32, gather="all_gather")
    reset_wire_stats()
    out["routed"] = reduce_state_in_graph({"w": torch.from_numpy(_uniform((WORLD, 128), seed=13)[rank])},
                                          {"w": Reduction.SUM}, policy=pol)["w"]
    out["routed_wire"] = dict(wire_stats()["last_sync"])
    # the eager class API through HostSync, at both widths, twice (the residual carry)
    for bits in (8, 16):
        m = P.SumMetric(device="cpu", sync_policy=SyncPolicy(quantize_bits=bits, quantize_threshold=4))
        vec = _QVec(device="cpu", sync_policy=SyncPolicy(quantize_bits=bits, quantize_threshold=4, quantize_chunk=16))
        vec.update(torch.from_numpy(_uniform((WORLD, 64), seed=40 + bits)[rank]))
        m.update(torch.tensor([1.0, 2.0]))
        rounds = []
        for _ in range(2):
            vec.sync()
            rounds.append(vec.v.clone())
            vec.unsync()
        out[f"eager{bits}"] = (torch.stack(rounds), vec._sync_residuals[("v",)].clone(), float(m.compute()))
    dist.barrier()
    return out


def _worker(rank, init_file, out_dir):
    import pathlib

    out_dir = pathlib.Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        torch.save(_rank_cases(rank), out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quantized")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp / "init"), str(tmp)), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert not hung and [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.mark.parametrize("bits,atol", [(8, 0.05), (16, 1e-3)])
def test_quantized_allreduce_tolerance(ranks, bits, atol):
    n, chunk = TOLERANCE_CASES[bits]
    xs = _uniform((WORLD, n), seed=bits)
    pol = JS.SyncPolicy(quantize_bits=bits, quantize_chunk=chunk, gather="all_gather")
    want = np.asarray(_vmap_world(lambda x: JS.quantized_allreduce(x, "dp", policy=pol)[0], jnp.asarray(xs)))
    for r in range(WORLD):
        got = ranks[r][f"tol{bits}"].numpy()
        np.testing.assert_array_equal(got, want[r])  # bitwise the JAX package's
        np.testing.assert_allclose(got, xs.sum(axis=0), atol=atol)


def test_quantized_allreduce_mean(ranks):
    xs = _uniform((WORLD, 256), seed=7)
    pol = JS.SyncPolicy(quantize_bits=16, quantize_chunk=64, gather="all_gather")
    want = np.asarray(_vmap_world(lambda x: JS.quantized_allreduce(x, "dp", mean=True, policy=pol)[0], jnp.asarray(xs)))
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["mean"].numpy(), want[r])
    np.testing.assert_allclose(ranks[0]["mean"].numpy(), xs.mean(axis=0), atol=1e-3)


def test_quantized_allreduce_residual_semantics(ranks):
    xs, rs = _uniform((WORLD, 128), seed=11), _uniform((WORLD, 128), seed=12) * np.float32(0.01)
    pol = JS.SyncPolicy(quantize_bits=8, quantize_chunk=32, gather="all_gather")
    out, res = _vmap_world(lambda x, r: JS.quantized_allreduce(x, "dp", policy=pol, residual=r),
                           jnp.asarray(xs), jnp.asarray(rs))
    for r in range(WORLD):
        got, new_res = ranks[r]["residual"]
        np.testing.assert_array_equal(got.numpy(), np.asarray(out[r]))
        np.testing.assert_array_equal(new_res.numpy(), np.asarray(res[r]))
        assert float(new_res.abs().max()) <= 1.02 / (2 * 127)
    np.testing.assert_allclose(ranks[0]["residual"][0].numpy(), (xs + rs).sum(axis=0), atol=0.05)


def test_integer_states_never_quantized_bitwise(ranks):
    ints = np.random.RandomState(4).randint(-(10 ** 6), 10 ** 6, size=(WORLD, 64)).astype(np.int32)
    for r in range(WORLD):
        got = ranks[r]["ints"]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ints.sum(axis=0))


def test_quantized_routing_picked_for_large_float_sum(ranks):
    xs = _uniform((WORLD, 128), seed=13)
    pol = JS.SyncPolicy(quantize_bits=8, quantize_threshold=64, quantize_chunk=32, gather="all_gather")
    want = np.asarray(_vmap_world(lambda s: JSYNC.reduce_state_in_graph(s, {"w": JReduction.SUM}, "dp", policy=pol),
                                  {"w": jnp.asarray(xs)})["w"])
    wire = ranks[0]["routed_wire"]
    # pmax of 4 scales (16 B), int32 reduce-scatter (512 B), gathers of 32 int8 and 1 scale per rank
    assert wire["collectives_issued"] == 4
    assert wire["bytes_reduced"] == 2 * 3 * 16 // 4 + 3 * 512 // 4
    assert wire["bytes_gathered"] == 3 * 32 + 3 * 4
    for r in range(WORLD):
        np.testing.assert_array_equal(ranks[r]["routed"].numpy(), want[r])


@pytest.mark.parametrize("bits", [8, 16])
def test_quantized_eager_hostsync_within_the_bound(ranks, bits):
    """``SyncPolicy(quantize_bits=...)`` syncs a float SUM bucket through
    ``HostSync``: every element within the chunk's quantization bound of the
    exact sum (world · scale / 2, the scales of each rank's input), bitwise
    alike on every rank; a second round with the residual carry loses no
    more; a 2-element bucket below the threshold stays exact."""
    xs = _uniform((WORLD, 64), seed=40 + bits)
    qmax = 127 if bits == 8 else 32767
    exact = xs.astype(np.float64).sum(axis=0)
    scale = np.abs(xs).reshape(WORLD, 4, 16).max(axis=2) / qmax  # (rank, chunk)
    bound = np.repeat(scale.sum(axis=0) / 2, 16) * 1.0001 + 1e-6  # and float32 rounding of the sum
    for r in range(WORLD):
        rounds, residual, small = ranks[r][f"eager{bits}"]
        assert small == WORLD * 3.0
        np.testing.assert_array_equal(rounds.numpy(), ranks[0][f"eager{bits}"][0].numpy())
        assert (np.abs(rounds[0].numpy() - exact) <= bound).all()
        assert (np.abs(rounds[1].numpy() - exact) <= 2 * bound).all()
        assert residual.shape == (64,) and float(residual.abs().max()) <= scale[r].max() / 2 * 1.01


# ---------------------------------------------------------------------------
# the eager route in one process
# ---------------------------------------------------------------------------

class _MirrorSync(SyncBackend):
    """Two ranks whose peer holds the same state (the sum is twice the local)."""

    def is_available(self) -> bool:
        return True

    def world_size(self) -> int:
        return 2

    def sync_tensor(self, value, reduction):
        if reduction == Reduction.NONE:
            return torch.stack([value, value])
        if reduction == Reduction.SUM:
            return value * 2
        raise NotImplementedError(reduction)

    def all_gather_object(self, obj):
        return [obj, obj]


class _QVec(P.Metric):
    full_state_update = False

    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_state("v", torch.zeros(64), dist_reduce_fx="sum")

    def update(self, x):
        self.v = self.v + x

    def compute(self):
        return torch.sum(self.v)


def test_eager_quantized_sync_with_error_feedback():
    x = torch.from_numpy(_uniform((64,), seed=40))
    m = _QVec(device="cpu", sync_policy=SyncPolicy(quantize_bits=16, quantize_threshold=4, quantize_chunk=16))
    m.update(x)
    m.sync(sync_backend=_MirrorSync())
    np.testing.assert_allclose(m.v.numpy(), 2 * x.numpy(), atol=1e-3)
    assert m._sync_residuals[("v",)].shape == (64,)
    m.unsync()
    assert torch.equal(m.v, x)  # the cache is exact
    m.sync(sync_backend=_MirrorSync())  # the carried residual folds back in
    np.testing.assert_allclose(m.v.numpy(), 2 * x.numpy(), atol=1e-3)
    m.unsync()


def test_eager_quantized_sync_skipped_for_addressed_backends():
    ms = [_QVec(device="cpu", sync_policy=SyncPolicy(quantize_bits=8, quantize_threshold=4)) for _ in range(2)]
    xs = [torch.from_numpy(_uniform((64,), seed=50 + r)) for r in range(2)]
    for m, x in zip(ms, xs):
        m.update(x)
    ms[0].sync(sync_backend=FakeSync([dict(m.metric_state) for m in ms], 0))
    assert torch.equal(ms[0].v, xs[0] + xs[1]) and not ms[0]._sync_residuals
    ms[0].unsync()


def test_eager_exact_policy_disables_quantized_sync():
    x = torch.from_numpy(_uniform((64,), seed=60))
    m = _QVec(device="cpu", sync_policy=SyncPolicy(exact=True, quantize_bits=8, quantize_threshold=4))
    m.update(x)
    m.sync(sync_backend=_MirrorSync())
    assert torch.equal(m.v, 2 * x) and not m._sync_residuals
    m.unsync()
