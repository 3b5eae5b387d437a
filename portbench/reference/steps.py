"""Plain reference of the training step the recipes run: the
class-balanced cross-entropy (the CVCS reference's ``wCEL`` with
``ignore_background``) and SGD with momentum and coupled weight decay
(its ``SGD2``: lr 6e-3 at epoch 0, momentum 0.9, weight decay 1e-5).

- Class weights: over every pixel of the training scenes' masks, the
  count of each class but the background; w_j = total / (15 * count_j),
  0 for a class that never occurs; the background weighs 0.
- Loss: sum over pixels of w[t] * (logsumexp(logits) - logits[t]),
  divided by the sum of w[t], on float32 logits.
- SGD: d = g + wd * p; the momentum buffer is d at the first step and
  0.9 * buffer + d after; p -= lr * buffer.
"""

from __future__ import annotations

import numpy as np
import torch

LR, MOMENTUM, WEIGHT_DECAY = 6e-3, 0.9, 1e-5


def class_weights(masks: list, num_classes: int) -> np.ndarray:
    counts = sum(np.bincount(m.reshape(-1), minlength=num_classes)
                 [:num_classes] for m in masks).astype(np.float64)
    active = counts[1:]
    w = np.where(active > 0, active.sum() / (len(active)
                                             * np.maximum(active, 1)), 0.0)
    return np.concatenate([[0.0], w]).astype(np.float32)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, -1)
    picked = logits.gather(-1, labels[..., None])[..., 0]
    w = weights[labels]
    return (w * (lse - picked)).sum() / w.sum().clamp_min(1e-12)


def train_steps(ref, cfg: dict, weights: dict, batches, class_w, prec="f32"):
    """The reference's steps on ``batches`` [(images uint8 NHWC, labels)]
    from ``weights``: (losses, the first step's gradients, the parameters
    after the last step), the last two by name."""
    params = {k: v.detach().clone().requires_grad_(
        not k.endswith(("running_mean", "running_var")))
        for k, v in weights.items()}
    trained = [k for k, v in params.items() if v.requires_grad]
    buf, losses, first = {}, [], None
    for images, labels in batches:
        logits = ref.forward(params, images.float(), cfg, train=True,
                             prec=prec)
        loss = weighted_ce(logits, labels, class_w)
        grads = torch.autograd.grad(loss, [params[k] for k in trained])
        losses.append(float(loss))
        with torch.no_grad():
            for k, g in zip(trained, grads):
                d = g + WEIGHT_DECAY * params[k]
                buf[k] = d if k not in buf else MOMENTUM * buf[k] + d
                params[k] -= LR * buf[k]
        if first is None:
            first = dict(zip(trained, (g.detach() for g in grads)))
    return losses, first, {k: params[k].detach() for k in trained}
