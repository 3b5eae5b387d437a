"""Segmentation losses on NHWC logits, computed in f32 (port of
``cvcs_tpu/ops/losses.py``).

The reference's loss factory names: "CEL" (cross-entropy), "wCEL"
(cross-entropy with class weights), "MSE", and the Dice losses its config
docs name, "DL" and "DEL" (CE + Dice). Semantics are the JAX package's:

* ``cross_entropy`` reduces as torch's weighted mean,
  sum(w[t] * ce) / max(sum(w[t]), 1e-12), over the pixels that count;
* a label outside [0, C) gets weight 0 (a bare ``F.cross_entropy``
  raises there), as does ``ignore_index`` (0 under
  ``ignore_background``);
* one-hot targets are comparisons with the class index, so an
  out-of-range label has an all-zero row (``jax.nn.one_hot``'s rule).

Under :func:`cvcs_tpu_torch.core.mesh.data_parallel` each loss reduces
over the global batch, as JAX's do on a sharded batch: the sums behind
cross-entropy's sum(w * ce) / sum(w), the MSE mean and Dice's per-class
sums are summed over the data group, so every rank computes the loss of
the global batch. Its gradient reaches this rank's logits alone (the
ranks' parameter gradients are then summed by the train step). Under
:func:`cvcs_tpu_torch.core.mesh.spatial_parallel` the logits are the
rank's rows and the sums span every rank of the mesh.
"""

from __future__ import annotations

import torch

from cvcs_tpu_torch.core import mesh as mesh_lib


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    classes = torch.arange(num_classes, device=labels.device)
    return (labels.unsqueeze(-1) == classes).to(torch.float32)


def cross_entropy(logits, labels, weights=None, ignore_index=None):
    """torch ``nn.CrossEntropyLoss`` semantics on (..., C) logits, with
    out-of-range labels weighted 0."""
    logits = logits.to(torch.float32)
    num_classes = logits.shape[-1]
    labels = labels.to(torch.int64)
    valid = ((labels >= 0) & (labels < num_classes)).to(torch.float32)
    if ignore_index is not None:
        valid = torch.where(labels == ignore_index, 0.0, valid)
    onehot = _one_hot(labels.clamp(0, num_classes - 1), num_classes)
    lse = torch.logsumexp(logits, dim=-1)
    ce = lse - (logits * onehot).sum(-1)
    if weights is not None:
        w = (weights.to(torch.float32) * onehot).sum(-1) * valid
    else:
        w = valid
    sums = mesh_lib.dp_sum(torch.stack([(ce * w).sum(), w.sum()]),
                           own_grad=True)
    return sums[0] / torch.clamp(sums[1], min=1e-12)


def mse(logits, labels):
    """Mean squared error between the class scores and the one-hot target."""
    logits = logits.to(torch.float32)
    onehot = _one_hot(labels.to(torch.int64), logits.shape[-1])
    sq = (logits - onehot) ** 2
    if mesh_lib.dp_size() == 1:
        return sq.mean()
    return (mesh_lib.dp_sum(sq.sum(), own_grad=True)
            / (sq.numel() * mesh_lib.dp_size()))


def dice(logits, labels, ignore_index=None, eps: float = 1.0):
    """Soft multiclass Dice loss, macro-averaged over classes."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    labels = labels.to(torch.int64)
    onehot = _one_hot(labels, logits.shape[-1])
    if ignore_index is not None:
        keep = (labels != ignore_index).unsqueeze(-1).to(torch.float32)
        probs = probs * keep
        onehot = onehot * keep
    axes = tuple(range(probs.dim() - 1))
    inter = mesh_lib.dp_sum((probs * onehot).sum(axes), own_grad=True)
    denom = mesh_lib.dp_sum(probs.sum(axes) + onehot.sum(axes),
                            own_grad=True)
    return 1.0 - ((2.0 * inter + eps) / (denom + eps)).mean()


def dice_cross_entropy(logits, labels, weights=None, ignore_index=None,
                       dice_weight: float = 0.5):
    """CE + Dice blend ("DEL")."""
    return ((1.0 - dice_weight)
            * cross_entropy(logits, labels, weights, ignore_index)
            + dice_weight * dice(logits, labels, ignore_index))


LOSSES = {
    "CEL": lambda logits, labels, weights, ignore_index: cross_entropy(
        logits, labels, None, ignore_index),
    "wCEL": cross_entropy,
    "MSE": lambda logits, labels, weights, ignore_index: mse(logits, labels),
    "DL": lambda logits, labels, weights, ignore_index: dice(
        logits, labels, ignore_index),
    "DEL": dice_cross_entropy,
}


def build_loss(name: str, weights=None, ignore_background: bool = False,
               device=None):
    """Loss factory with the reference's config names. Returns
    ``fn(logits, labels) -> scalar``; "CEL", "wCEL", "DL" and "DEL" ignore
    class 0 under ``ignore_background``. ``weights`` (C,) go to
    ``device``."""
    if name not in LOSSES:
        raise ValueError(f"unknown loss {name!r}; available: {sorted(LOSSES)}")
    if name == "wCEL" and weights is None:
        raise ValueError("wCEL requires class weights")
    ignore_index = 0 if ignore_background else None
    fn = LOSSES[name]
    w = (None if weights is None else
         torch.as_tensor(weights, dtype=torch.float32, device=device))

    def loss_fn(logits, labels):
        return fn(logits, labels, w, ignore_index)

    return loss_fn
