"""The port's speech-recognition error rates against the JAX package, on the CPU.

WER, CER, MER, WIL and WIP: the functionals' values and the classes'
float32 states bitwise equal to the JAX package's, over seeded transcripts,
empty strings and unicode; the string helpers against their ``*_plain``
numpy oracles; one host-library call per update. Then the audio and
speech-recognition classes' states synced over two gloo ranks against one
process. The JAX package is imported by a fixture, not by the module, so
the two spawned ranks, which import this module, do not load JAX.
"""
import datetime
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torchmetrics_tpu_torch as P
import torchmetrics_tpu_torch.functional.audio as PA
import torchmetrics_tpu_torch.functional.text as PT
from torchmetrics_tpu_torch import _native
from torchmetrics_tpu_torch.functional.text import helper as PH

CPU = {"device": "cpu"}
FUNCS = {"word_error_rate": "WordErrorRate", "char_error_rate": "CharErrorRate", "match_error_rate": "MatchErrorRate",
         "word_information_lost": "WordInfoLost", "word_information_preserved": "WordInfoPreserved"}
STATES = {"WordErrorRate": ("errors", "total"), "CharErrorRate": ("errors", "total"),
          "MatchErrorRate": ("errors", "total"), "WordInfoLost": ("errors", "target_total", "preds_total"),
          "WordInfoPreserved": ("errors", "target_total", "preds_total")}
VOCAB = ["the", "a", "cat", "sat", "on", "mat", "dog", "ran", "über", "naïve", "日本", "語", "señor", "x"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module. torch's CPU build deadlocks in
    MKL's batched LU factorisation (SDR's solve) in a process whose intra-op
    thread count was changed before (as another module's fixture does when
    the suite's workers run it first), and one thread avoids that; it also
    keeps the suite's parallel workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _transcripts(seed, n=24):
    """(hypotheses, references): seeded references with about 10% substitutions, deletions and insertions."""
    rng = np.random.RandomState(seed)
    refs, hyps = [], []
    for _ in range(n):
        ref = list(rng.choice(VOCAB, rng.randint(0, 12)))
        hyp = []
        for word in ref:
            r = rng.rand()
            if r < 0.1:
                hyp.append(str(rng.choice(VOCAB)))
            elif r < 0.2:
                continue
            else:
                hyp.append(word)
            if rng.rand() < 0.1:
                hyp.append(str(rng.choice(VOCAB)))
        refs.append(" ".join(ref))
        hyps.append(" ".join(hyp))
    return hyps, refs


CASES = {
    "seeded": _transcripts(0),
    "empty_strings": (["", "the cat", "", "a"], ["the cat", "", "", "a b c"]),
    "unicode": (["über naïve 日本語", "señor"], ["uber naive 日本 語", "señor señora"]),
    "single_string": ("the cat sat on the mat", "the cat sat on a mat"),
    "ragged_lists": (["a b", "c d", "e"], ["a b", "c"]),  # zip stops at the shorter list
}


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def jax_text():
    """The JAX package's root and functional text modules."""
    import torchmetrics_tpu as J
    import torchmetrics_tpu.functional.text as JT

    return J, JT


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("func", sorted(FUNCS))
def test_functionals_bitwise_jax(case, func, jax_text):
    JT = jax_text[1]
    preds, target = CASES[case]
    want = np.asarray(getattr(JT, func)(preds, target))
    got = getattr(PT, func)(preds, target, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ()
    assert _bits(got.numpy()) == _bits(want) or (np.isnan(want) and np.isnan(got.numpy())), (case, func, got, want)


@pytest.mark.parametrize("name", sorted(STATES))
def test_classes_states_bitwise_jax(name, jax_text):
    jm, pm = getattr(jax_text[0], name)(), getattr(P, name)(**CPU)
    assert pm.jittable is False and not pm._use_jit
    for case in ("seeded", "empty_strings", "unicode", "single_string"):
        preds, target = CASES[case]
        jm.update(preds, target)
        pm.update(preds, target)
    for state in STATES[name]:
        got = getattr(pm, state)
        assert got.dtype == torch.float32 and got.device == torch.device("cpu")
        assert _bits(got.numpy()) == _bits(np.asarray(getattr(jm, state))), (name, state)
    assert _bits(pm.compute().numpy()) == _bits(np.asarray(jm.compute())), name
    assert pm.plot_lower_bound == jm.plot_lower_bound
    assert getattr(pm, "plot_upper_bound", None) == getattr(jm, "plot_upper_bound", None)


@pytest.mark.parametrize("name", sorted(STATES))
def test_one_library_call_per_update(name, monkeypatch):
    calls = []
    real = _native.edit_distance_batch

    def counted(preds, targets):
        calls.append(len(preds))
        return real(preds, targets)

    monkeypatch.setattr(_native, "edit_distance_batch", counted)
    m = getattr(P, name)(**CPU)
    preds, target = CASES["seeded"]
    m.update(preds, target)
    m.update(preds[:5], target[:5])
    assert calls == [len(preds), 5]


def test_helper_against_its_plain_oracles():
    rng = np.random.RandomState(3)
    for _ in range(40):
        a = [str(t) for t in rng.randint(0, 6, rng.randint(0, 15))]
        b = [str(t) for t in rng.randint(0, 6, rng.randint(0, 15))]
        assert PH.edit_distance_fast(a, b) == PH.edit_distance_fast_plain(a, b)
        assert PH.edit_distance_with_counts(a, b) == PH.edit_distance_with_counts_plain(a, b)
        s, d, ins, hits = PH.edit_distance_with_counts(a, b)
        assert s + d + ins == PH.edit_distance_fast(a, b) and hits + s + d == len(a) and hits + s + ins == len(b)
    assert PH._as_list("one") == ["one"] and PH._as_list(("a", "b")) == ["a", "b"]
    assert PH.ngram_counts("abab", 2) == {("a", "b"): 2, ("b", "a"): 1}
    assert PH.ngram_counts_upto(["x", "y"], 2) == {("x",): 1, ("y",): 1, ("x", "y"): 1}


def test_state_counts_are_the_library_counts():
    """The WER state against the plain Levenshtein counts of every pair."""
    preds, target = CASES["seeded"]
    m = P.WordErrorRate(**CPU)
    m.update(preds, target)
    counts = _native.edit_distance_counts_batch_plain([p.split() for p in preds], [t.split() for t in target])
    assert float(m.errors) == float(counts[:, :3].sum())
    assert float(m.total) == float(sum(len(t.split()) for t in target))


def test_functionals_live_on_the_card_by_default():
    if torch.cuda.is_available():  # pragma: no cover - the CPU suite has no card
        assert PT.word_error_rate("a", "a").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PT.word_error_rate("a", "a")


# ---------------------------------------------------------------------------- two gloo ranks
WORLD = 2
DEADLINE_S = 120


def _metrics():
    """The separation metrics and SRMR (whose ``_MeanAudioMetric`` sums PESQ and STOI share) and two error rates."""
    return [P.SignalNoiseRatio(**CPU), P.ScaleInvariantSignalDistortionRatio(**CPU),
            P.SignalDistortionRatio(filter_length=32, **CPU),
            P.PermutationInvariantTraining(PA.scale_invariant_signal_noise_ratio, **CPU),
            P.SpeechReverberationModulationEnergyRatio(fs=8000, **CPU), P.WordErrorRate(**CPU),
            P.WordInfoLost(**CPU)]


def _rank_update(metrics, rank):
    rng = np.random.RandomState(30 + rank)
    target = rng.randn(2, 2, 800).astype(np.float32)
    preds = (target[:, ::-1] + 0.5 * rng.randn(2, 2, 800)).astype(np.float32)
    for m in metrics[:3]:
        m.update(_t(preds[:, 0]), _t(target[:, 0]))
    metrics[3].update(_t(preds), _t(target))
    t = np.arange(4000) / 8000.0
    metrics[4].update(_t(np.sin(2 * np.pi * 200 * (1 + rank) * t)[None].astype(np.float32)))
    hyps, refs = ["the cat sat", "on a mat", ""][rank:], ["the cat sat down", "on the mat", "a"][rank:]
    metrics[5].update(hyps, refs)
    metrics[6].update(hyps, refs)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _gloo_rank(rank, init_file, out_dir):
    import pathlib

    out_dir = pathlib.Path(out_dir)
    try:
        dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=WORLD, rank=rank,
                                timeout=datetime.timedelta(seconds=60))
        metrics = _metrics()
        _rank_update(metrics, rank)
        out = []
        for m in metrics:
            m.sync()
            out.append({k: v.clone() for k, v in m.metric_state.items()})
            m.unsync()
        torch.save(out, out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_audio_and_asr_states_synced_over_two_gloo_ranks_equal_one_process(tmp_path):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_gloo_rank, args=(r, str(tmp_path / "init"), str(tmp_path)), daemon=True)
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    errors = [f.read_text() for f in sorted(tmp_path.glob("rank*.err"))]
    assert not errors, "\n".join(errors)
    assert not hung and [p.exitcode for p in procs] == [0] * WORLD
    one = _metrics()
    for rank in range(WORLD):
        _rank_update(one, rank)
    for r in range(WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
        for m, states in zip(one, got):
            assert states.keys() == m.metric_state.keys()
            for name, value in states.items():  # float32 sums of two ranks: the edit counts exact
                torch.testing.assert_close(value, m.metric_state[name], rtol=1e-6, atol=0)
