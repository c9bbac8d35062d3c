"""The PyTorch port stands alone: no JAX, nothing of the JAX package, no
``transformers`` or ``nltk`` at import time (only the default-model loaders
and ROUGE's stemmer import them), and no quiet fall back to the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import torchmetrics_tpu_torch as P

PKG = pathlib.Path(P.__file__).resolve().parent
REPO = PKG.parent


def test_import_leaves_jax_out_of_sys_modules():
    """Every module of the package, imported in a fresh process."""
    code = (
        "import importlib, pkgutil, sys, torchmetrics_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(torchmetrics_tpu_torch.__path__, 'torchmetrics_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "new = ['buffers', 'parallel.sharded_compute', 'classification.average_precision', "
        "'classification.group_fairness', 'classification.hinge', 'classification.ranking', "
        "'classification.recall_fixed_precision', 'functional.classification._exact_jit', "
        "'functional.classification.group_fairness', 'functional.classification.hinge', "
        "'functional.classification.ranking', 'functional.classification.specificity_sensitivity', "
        "'aggregation', 'parallel.strategies', 'parallel.sync', 'online', 'wrappers', 'wrappers.abstract', "
        "'wrappers.bootstrapping', 'wrappers.classwise', 'wrappers.feature_share', 'wrappers.minmax', "
        "'wrappers.multioutput', 'wrappers.multitask', 'wrappers.running', 'wrappers.tracker', "
        "'_capture', 'streaming', 'regression', 'regression.mse', 'regression.mae', 'regression.log_mse', "
        "'regression.mape', 'regression.r2', 'regression.other', 'regression.pearson', 'regression.spearman', "
        "'functional.regression', 'functional.regression.kendall', 'functional.regression.spearman', "
        "'functional.regression.pearson', 'functional.regression.concordance', 'functional.regression.csi', "
        "'functional.regression.kl_divergence', 'functional.regression.tweedie_deviance', "
        "'functional.regression.cosine_similarity', 'functional.regression.explained_variance', "
        "'functional.regression.r2', 'functional.regression.rse', 'functional.regression.minkowski', "
        "'functional.regression.mape', 'functional.regression.log_mse', 'functional.regression.mae', "
        "'functional.regression.mse', 'retrieval', 'retrieval.base', 'retrieval.metrics', "
        "'retrieval.precision_recall_curve', 'functional.retrieval', 'functional.retrieval._ops', "
        "'image', 'image.ssim', 'image.psnr', 'image.simple', 'functional.image', 'functional.image.helper', "
        "'functional.image.ssim', 'functional.image.psnr', 'functional.image.psnrb', 'functional.image.uqi', "
        "'functional.image.vif', 'functional.image.sam', 'functional.image.scc', 'functional.image.d_lambda', "
        "'functional.image.rmse_sw', 'functional.image.tv', 'functional.image.gradients', 'models', "
        "'models.pretrained', 'models.inception', 'models.lpips', 'image.fid', 'image.kid', 'image.inception', "
        "'image.mifid', 'image.lpip', 'image.perceptual_path_length', 'functional.image.lpips', "
        "'functional.image.perceptual_path_length', '_native', 'detection', 'detection.iou', "
        "'detection.mean_ap', 'detection.panoptic_qualities', 'functional.detection', "
        "'functional.detection.box_ops', 'functional.detection.coco_eval', "
        "'functional.detection.panoptic_quality', 'audio', 'audio.metrics', 'functional.audio', "
        "'functional.audio.snr', 'functional.audio.sdr', 'functional.audio.pit', 'functional.audio.stoi', "
        "'functional.audio.srmr', 'functional.audio.pesq', 'text', 'text.asr', 'functional.text', "
        "'functional.text.asr', 'functional.text.helper', 'utils.imports', 'text.translate', 'text.other', "
        "'text.perplexity', 'functional.text.bleu', 'functional.text.sacre_bleu', 'functional.text.chrf', "
        "'functional.text.ter', 'functional.text.eed', 'functional.text.edit', 'functional.text.rouge', "
        "'functional.text.squad', 'functional.text.perplexity', 'functional.text.bert', "
        "'functional.text.infolm', 'multimodal', 'multimodal.clip_score', 'multimodal.clip_iqa', "
        "'functional.multimodal', 'functional.multimodal.clip_score', 'functional.multimodal.clip_iqa', "
        "'parallel.elastic', 'utils.checkpoint', 'observability', 'observability.registry', "
        "'observability.spans', 'observability.export', 'observability.ledger', 'observability.autotune', "
        "'debug', 'utils.profiler']\n"
        "missing = [m for m in new if 'torchmetrics_tpu_torch.' + m not in names]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', "
        "'torchmetrics_tpu.', 'transformers.', 'nltk.')) or m in ('torchmetrics_tpu', 'transformers', 'nltk'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / name for name in ("chip_smoke.py",
                                                                                       "bincount_ablation.py",
                                                                                       "sdr_solve_probe.py",
                                                                                       "tdigest_pass_breakdown.py",
                                                                                       "untraced_update_timing.py")],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "torchmetrics_tpu"), f"{path} imports {name}"


def test_metric_without_device_raises_when_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.MulticlassAccuracy(num_classes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.MulticlassAUROC(num_classes=3, thresholds=8)


def test_explicit_cpu_device_is_kept():
    m = P.MulticlassAccuracy(num_classes=3, device="cpu")
    assert m.device == torch.device("cpu")
    assert all(b.device == torch.device("cpu") for b in m.buffers())
