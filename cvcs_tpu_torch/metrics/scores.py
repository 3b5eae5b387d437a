"""Confusion-derived scores with the reference's formulas and edge cases
(port of ``cvcs_tpu/metrics/scores.py``), numpy on the host:

* per class tp = conf[i, i], fp = column sum - tp, fn = row sum - tp;
* precision tp/(tp+fp), recall tp/(tp+fn), IoU tp/(tp+fp+fn), F1
  2tp/(2tp+fp+fn);
* a class is excluded (score 0, left out of the macro mean) when
  precision: tp+fp == 0; recall, IoU and F1: tp+fn == 0;
* overall accuracy = trace / sum;
* :func:`print_metrics` renders the reference's two tables (scores, then
  per-class IoU) and returns the metric dict.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from cvcs_tpu_torch.data.palette import LABELS
from cvcs_tpu_torch.utils.tables import get_table_cls


def _class_scores(conf: np.ndarray,
                  formula: Callable[[float, float, float], float],
                  ignored: Callable[[float, float, float], bool]):
    scores, excluded = [], []
    for i in range(conf.shape[0]):
        tp = float(conf[i, i])
        fp = float(conf[:, i].sum()) - tp
        fn = float(conf[i, :].sum()) - tp
        if ignored(tp, fp, fn):
            scores.append(0.0)
            excluded.append(i)
        else:
            scores.append(formula(tp, fp, fn))
    return np.asarray(scores), excluded


def _wrap(conf, formula, ignored, mean: bool, return_excluded: bool):
    scores, excluded = _class_scores(np.asarray(conf), formula, ignored)
    if mean:
        kept = [x for i, x in enumerate(scores) if i not in excluded]
        scores = float(np.mean(kept)) if kept else float("nan")
    return (scores, excluded) if return_excluded else scores


def precision(conf, macro: bool = False, return_excluded: bool = False):
    return _wrap(conf, lambda tp, fp, fn: tp / (tp + fp),
                 lambda tp, fp, fn: tp + fp == 0, macro, return_excluded)


def recall(conf, macro: bool = False, return_excluded: bool = False):
    return _wrap(conf, lambda tp, fp, fn: tp / (tp + fn),
                 lambda tp, fp, fn: tp + fn == 0, macro, return_excluded)


def iou(conf, mean: bool = False, return_excluded: bool = False):
    return _wrap(conf, lambda tp, fp, fn: tp / (tp + fn + fp),
                 lambda tp, fp, fn: tp + fn == 0, mean, return_excluded)


def f1(conf, mean: bool = False, return_excluded: bool = False):
    # F1 reuses IoU's ignore condition, as the reference does
    return _wrap(conf, lambda tp, fp, fn: (2 * tp) / (2 * tp + fn + fp),
                 lambda tp, fp, fn: tp + fn == 0, mean, return_excluded)


def accuracy(conf) -> float:
    conf = np.asarray(conf, np.float64)
    total = conf.sum()
    return float(np.trace(conf) / total) if total else float("nan")


def compute_metrics(conf) -> dict:
    """All headline scores (the reference's keys)."""
    values, excluded = iou(conf, mean=False, return_excluded=True)
    return {
        "perclass_IoU": values.tolist(),
        "mIoU": iou(conf, mean=True),
        "precision_score": precision(conf, macro=True),
        "recall_score": recall(conf, macro=True),
        "dice_score": f1(conf, mean=True),
        "oa_score": accuracy(conf),
        "excluded": excluded,
    }


def print_metrics(conf, silent: bool = False) -> dict:
    """Print the reference's score table and per-class IoU table (unless
    ``silent``); return the metric dict without the excluded list."""
    table = get_table_cls()
    m = compute_metrics(conf)
    t = table(["Metric", "Score"])
    t.align = "r"
    for name, key in (("mIoU", "mIoU"), ("mPrec", "precision_score"),
                      ("mRec", "recall_score"), ("Dice", "dice_score"),
                      ("OA", "oa_score")):
        t.add_row([name, m[key]])
    iou_table = table(["Class", "IoU"])
    iou_table.align = "r"
    for i, score in enumerate(m["perclass_IoU"]):
        iou_table.add_row([LABELS.get(i, str(i)), score])
    if not silent:
        print(t)
        print(f"Excluded classes (not in target): {m['excluded']}")
        print(iou_table, flush=True)
    return {k: v for k, v in m.items() if k != "excluded"}
