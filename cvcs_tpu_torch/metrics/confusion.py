"""Confusion matrix accumulated on the device (port of
``cvcs_tpu/metrics/confusion.py``).

``conf[target, pred]`` as torchmetrics lays it out; pixels whose target or
prediction is out of range, and ``ignore_index`` targets, are dropped.
The device matrix is int64 (a ``bincount`` of target * C + pred); drivers
fold each chunk's matrix into an exact host total
(:class:`HostConfusion`), one transfer per chunk.
"""

from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(num_classes: int = 16, device=None) -> torch.Tensor:
    """Fresh (C, C) zero matrix on ``device``."""
    return torch.zeros((num_classes, num_classes), dtype=torch.int64,
                       device=device)


def update_confusion(conf: torch.Tensor, pred: torch.Tensor,
                     target: torch.Tensor, num_classes: int = 16,
                     ignore_index: int | None = None) -> torch.Tensor:
    """Fold one batch into ``conf`` (in place; returns it)."""
    t = target.reshape(-1).to(torch.int64)
    p = pred.reshape(-1).to(torch.int64)
    valid = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if ignore_index is not None:
        valid &= t != ignore_index
    idx = (t * num_classes + p)[valid]
    conf += torch.bincount(idx, minlength=num_classes * num_classes).view(
        num_classes, num_classes)
    return conf


def normalize_rows(conf) -> np.ndarray:
    """Row-normalised confusion (torchmetrics ``normalize='true'``); zero
    rows stay zero."""
    conf = np.asarray(conf, dtype=np.float64)
    row = conf.sum(axis=1, keepdims=True)
    return np.where(row > 0, conf / np.maximum(row, 1), 0.0)


class HostConfusion:
    """Exact int64 host total; fold device chunk matrices into it."""

    def __init__(self, num_classes: int = 16):
        self.num_classes = num_classes
        self.total = np.zeros((num_classes, num_classes), np.int64)

    def fold(self, device_conf: torch.Tensor) -> None:
        self.total += device_conf.cpu().numpy().astype(np.int64)

    def normalized(self) -> np.ndarray:
        return normalize_rows(self.total)
