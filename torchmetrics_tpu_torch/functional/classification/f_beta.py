"""F-beta / F1 (binary / multiclass / multilabel).

Counterpart of ``torchmetrics_tpu/functional/classification/f_beta.py``.
"""
from functools import partial

from ._factory import _binary_stat_metric, _multiclass_stat_metric, _multilabel_stat_metric
from ._reduce import _fbeta_reduce


def _check_beta(beta, validate_args: bool) -> None:
    if validate_args and not (isinstance(beta, float) and beta > 0):
        raise ValueError(f"Expected argument `beta` to be a float larger than 0, but got {beta}.")


def binary_fbeta_score(preds, target, beta, threshold=0.5, multidim_average="global", ignore_index=None,
                       validate_args=True):
    _check_beta(beta, validate_args)
    return _binary_stat_metric(preds, target, partial(_fbeta_reduce, beta=beta), threshold, multidim_average,
                               ignore_index, validate_args)


def multiclass_fbeta_score(preds, target, beta, num_classes, average="macro", top_k=1, multidim_average="global",
                           ignore_index=None, validate_args=True):
    _check_beta(beta, validate_args)
    return _multiclass_stat_metric(preds, target, partial(_fbeta_reduce, beta=beta), num_classes, average, top_k,
                                   multidim_average, ignore_index, validate_args)


def multilabel_fbeta_score(preds, target, beta, num_labels, threshold=0.5, average="macro",
                           multidim_average="global", ignore_index=None, validate_args=True):
    _check_beta(beta, validate_args)
    return _multilabel_stat_metric(preds, target, partial(_fbeta_reduce, beta=beta), num_labels, threshold, average,
                                   multidim_average, ignore_index, validate_args)


def binary_f1_score(preds, target, threshold=0.5, multidim_average="global", ignore_index=None, validate_args=True):
    return binary_fbeta_score(preds, target, 1.0, threshold, multidim_average, ignore_index, validate_args)


def multiclass_f1_score(preds, target, num_classes, average="macro", top_k=1, multidim_average="global",
                        ignore_index=None, validate_args=True):
    return multiclass_fbeta_score(preds, target, 1.0, num_classes, average, top_k, multidim_average, ignore_index,
                                  validate_args)


def multilabel_f1_score(preds, target, num_labels, threshold=0.5, average="macro", multidim_average="global",
                        ignore_index=None, validate_args=True):
    return multilabel_fbeta_score(preds, target, 1.0, num_labels, threshold, average, multidim_average, ignore_index,
                                  validate_args)


def fbeta_score(preds, target, task, beta=1.0, threshold=0.5, num_classes=None, num_labels=None, average="micro",
                multidim_average="global", top_k=1, ignore_index=None, validate_args=True):
    """Task dispatcher."""
    from ...utils.enums import ClassificationTask

    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_fbeta_score(preds, target, beta, threshold, multidim_average, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)}` was passed.")
        return multiclass_fbeta_score(preds, target, beta, num_classes, average, top_k, multidim_average,
                                      ignore_index, validate_args)
    if not isinstance(num_labels, int):
        raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)}` was passed.")
    return multilabel_fbeta_score(preds, target, beta, num_labels, threshold, average, multidim_average,
                                  ignore_index, validate_args)


def f1_score(preds, target, task, threshold=0.5, num_classes=None, num_labels=None, average="micro",
             multidim_average="global", top_k=1, ignore_index=None, validate_args=True):
    """Task dispatcher."""
    return fbeta_score(preds, target, task, 1.0, threshold, num_classes, num_labels, average, multidim_average,
                       top_k, ignore_index, validate_args)
