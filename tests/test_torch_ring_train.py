"""Ring attention, the expert all-to-all and the dp x pp x tp train template
of the port, over a real 8-rank gloo group, against the JAX package.

One module fixture runs the JAX side in this process (ring attention on
the 8-device CPU mesh that ``tests/conftest.py`` forces, one JAX train
step on the 2 x 2 x 2 mesh), writes its inputs and the JAX parameters to
``tmp_path``, spawns the 8 ranks once and collects what each wrote. Every
check of the port runs in that spawn; the tests below read the results.
JAX is imported by the fixture, not by the module, so the spawned ranks
(which import this module) do not load it.
"""
import datetime
import pathlib
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
DEADLINE_S = 120
RING = (2, 64, 16)  # (B, T, D), T over the 8 ranks
GRAD = (1, 32, 8)
VOCAB, D_MODEL, D_HIDDEN = 32, 16, 32
BATCH, SEQ = 8, 8
LR = 1.0
STEPS = 40


def _ring_inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _a2a_input():
    return np.random.RandomState(7).randn(WORLD, WORLD, 6).astype(np.float32)


def _train_batch():
    rng = np.random.RandomState(11)
    return rng.randint(0, VOCAB, (BATCH, SEQ)), rng.randint(0, VOCAB, (BATCH, SEQ))


def _full_attention(q, k, v, causal=False):
    s = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        t = q.shape[-2]
        s = s.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), float("-inf"))
    return torch.softmax(s, dim=-1) @ v


# --------------------------------------------------------------- the ranks
def _local(x, rank, axis):
    return torch.from_numpy(np.ascontiguousarray(np.split(x, WORLD, axis=axis)[rank]))


def _rank_ring(rank):
    from torchmetrics_tpu_torch.parallel import expert_all_to_all, ring_attention

    out = {}
    q, k, v = (_local(x, rank, 1) for x in _ring_inputs(0, RING))
    for causal in (False, True):
        out[f"ring_causal{causal}"] = ring_attention(q, k, v, causal=causal)
    out["ring_bf16"] = ring_attention(*(x.to(torch.bfloat16) for x in (q, k, v)))
    for causal in (False, True):
        q, k, v = (_local(x, rank, 1).requires_grad_(True) for x in _ring_inputs(1, GRAD))
        (ring_attention(q, k, v, causal=causal) ** 2).sum().backward()
        out[f"grad_causal{causal}"] = torch.stack([q.grad, k.grad, v.grad])
    x = _local(_a2a_input(), rank, 0)
    once = expert_all_to_all(x, split_axis=1, concat_axis=1)
    out["a2a_once"], out["a2a_twice"] = once, expert_all_to_all(once, split_axis=1, concat_axis=1)
    return out


def _rank_train(rank, tmp):
    from torch.distributed.device_mesh import init_device_mesh

    import torchmetrics_tpu_torch as P
    from torchmetrics_tpu_torch.parallel import HostSync, make_demo_train_step
    from torchmetrics_tpu_torch.parallel.train_demo import local_batch, local_demo_params, params_from_jax

    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pp", "dp", "tp"))
    jax_params = dict(np.load(tmp / "jax_params.npz"))
    tokens, targets = (local_batch(torch.from_numpy(x), mesh) for x in _train_batch())
    step = make_demo_train_step(mesh, microbatches=2, lr=LR)
    params, loss, logits = step(local_demo_params(params_from_jax(jax_params, "cpu"), mesh), tokens, targets)
    out = {"coords": [mesh.get_local_rank(n) for n in ("pp", "dp", "tp")], "loss1": loss, "logits1": logits,
           "params1": params}
    # forty steps on fixed data from the same start, metrics updated each step
    sync = HostSync(group=mesh.get_group("dp"))
    acc = P.classification.MulticlassAccuracy(num_classes=VOCAB, average="micro", device="cpu", sync_backend=sync)
    ppl = P.Perplexity(device="cpu", sync_backend=sync)
    params, losses = local_demo_params(params_from_jax(jax_params, "cpu"), mesh), []
    for _ in range(STEPS):
        params, loss, logits = step(params, tokens, targets)
        acc.update(logits.reshape(-1, VOCAB), targets.reshape(-1))
        ppl.update(logits, targets)
        losses.append(float(loss))
    fresh = P.classification.MulticlassAccuracy(num_classes=VOCAB, average="micro", device="cpu", sync_backend=sync)
    fresh.update(logits.reshape(-1, VOCAB), targets.reshape(-1))
    out.update(losses=losses, acc=float(acc.compute()), ppl=float(ppl.compute()), fresh_acc=float(fresh.compute()))
    return out


def _worker(rank, tmp):
    tmp = pathlib.Path(tmp)
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{tmp / 'init'}", world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        out = _rank_ring(rank)
        out.update(_rank_train(rank, tmp))
        torch.save(out, tmp / f"rank{rank}.pt")
    except BaseException:
        (tmp / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------- the JAX side
def _jax_params(tmp):
    import jax

    from torchmetrics_tpu.parallel import init_demo_params

    params = init_demo_params(jax.random.PRNGKey(0), VOCAB, D_MODEL, D_HIDDEN, pp=2, tp=2)
    np.savez(tmp / "jax_params.npz", **{k: np.asarray(x) for k, x in params.items()})
    return params


def _jax_side(params):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as Ps

    from tests.helpers.testers import _shard_map
    from torchmetrics_tpu.parallel import demo_param_shardings, make_demo_train_step, ring_attention

    shard_map = _shard_map()
    devs = jax.devices("cpu")[:WORLD]
    mesh = Mesh(np.array(devs), ("sp",))
    out = {}
    q, k, v = (jnp.asarray(x) for x in _ring_inputs(0, RING))
    for causal in (False, True):
        fn = shard_map(lambda q, k, v, c=causal: ring_attention(q, k, v, "sp", causal=c), mesh=mesh,
                       in_specs=(Ps(None, "sp", None),) * 3, out_specs=Ps(None, "sp", None))
        out[f"ring_causal{causal}"] = np.asarray(jax.jit(fn)(q, k, v))

    tmesh = Mesh(np.array(devs).reshape(2, 2, 2), ("pp", "dp", "tp"))
    sh = demo_param_shardings(tmesh)
    params = {k: jax.device_put(x, sh[k]) for k, x in params.items()}
    tokens, targets = (jax.device_put(jnp.asarray(x), NamedSharding(tmesh, Ps("dp", None))) for x in _train_batch())
    new, loss, logits = make_demo_train_step(tmesh, microbatches=2, lr=LR)(params, tokens, targets)
    out.update(loss1=float(loss), logits1=np.asarray(logits), params1={k: np.asarray(x) for k, x in new.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks start as soon as the JAX parameters are written; the JAX
    side computes its results while they run."""
    tmp = tmp_path_factory.mktemp("ring_train")
    params = _jax_params(tmp)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, str(tmp)), daemon=True) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    try:
        jax_out = _jax_side(params)
    finally:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
    errors = [f.read_text() for f in sorted(tmp.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert not hung and [p.exitcode for p in procs] == [0] * WORLD
    return jax_out, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _gathered(ranks, key, axis):
    return np.concatenate([r[key].float().numpy() for r in ranks], axis=axis)


# ------------------------------------------------------------------- the checks
@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(runs, causal):
    jax_out, ranks = runs
    got = _gathered(ranks, f"ring_causal{causal}", 1)
    np.testing.assert_allclose(got, jax_out[f"ring_causal{causal}"], atol=1e-5)
    q, k, v = (torch.from_numpy(x) for x in _ring_inputs(0, RING))
    np.testing.assert_allclose(got, _full_attention(q, k, v, causal).numpy(), atol=1e-5)


def test_ring_attention_bf16_returns_bf16(runs):
    _, ranks = runs
    assert all(r["ring_bf16"].dtype == torch.bfloat16 for r in ranks)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16).float() for x in _ring_inputs(0, RING))
    np.testing.assert_allclose(_gathered(ranks, "ring_bf16", 1), _full_attention(q, k, v).numpy(), atol=0.05)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match_full_attention(runs, causal):
    _, ranks = runs
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in _ring_inputs(1, GRAD))
    (_full_attention(q, k, v, causal) ** 2).sum().backward()
    got = _gathered(ranks, f"grad_causal{causal}", 2)  # (3, B, T, D)
    for i, want in enumerate((q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(got[i], want.numpy(), atol=1e-4)


def test_expert_all_to_all_is_the_blockwise_transpose_and_its_own_inverse(runs):
    _, ranks = runs
    x = _a2a_input()
    np.testing.assert_array_equal(_gathered(ranks, "a2a_once", 0), x.transpose(1, 0, 2))
    np.testing.assert_array_equal(_gathered(ranks, "a2a_twice", 0), x)


def _local_slice(full, key, coords):
    pp, dp, tp = coords
    if key in ("embed", "out"):
        return full
    tp_dim = 2 if key in ("w1", "we1") else 1
    return np.split(np.split(full, 2, axis=0)[pp], 2, axis=tp_dim)[tp]


def test_one_train_step_matches_the_jax_step(runs):
    jax_out, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(float(r["loss1"]), jax_out["loss1"], atol=1e-5)
        rows = np.split(jax_out["logits1"], 2, axis=0)[r["coords"][1]]
        np.testing.assert_allclose(r["logits1"].numpy(), rows, atol=1e-5)
        assert sorted(r["params1"]) == sorted(jax_out["params1"])
        for key, got in r["params1"].items():
            want = _local_slice(jax_out["params1"][key], key, r["coords"])
            np.testing.assert_allclose(got.numpy(), want, atol=1e-5, err_msg=key)


def test_train_step_converges_and_feeds_metrics(runs):
    _, ranks = runs
    losses = ranks[0]["losses"]
    assert losses[-1] < losses[0] - 0.5, losses[::8]
    for r in ranks:
        assert r["losses"] == losses  # the global loss, on every rank
        assert 0.0 <= r["acc"] <= 1.0 and np.isfinite(r["ppl"]) and r["ppl"] > 1.0
        assert r["fresh_acc"] > 0.5
