"""Optimizers with the reference's recipes (port of
``cvcs_tpu/train/optim.py``):

* ``SGD1``: SGD(lr 1e-3, momentum 0.9, weight_decay 1e-5) + PolynomialLR
  (total_iters 5, power 1);
* ``SGD2``: SGD(lr 6e-3, momentum 0.9, weight_decay 1e-5) +
  PolynomialLR(total_iters 20);
* ``ADAM1``: Adam(lr 5e-3) + PolynomialLR(total_iters = epochs, power 2).

``torch.optim.SGD`` and ``torch.optim.Adam`` make the same updates as the
JAX package's optax chains: coupled weight decay added to the gradient
before the momentum trace, and the learning rate applied last. The
schedule steps per epoch: :meth:`OptimizerBundle.set_epoch` writes
``lr(epoch)`` into the parameter groups.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def polynomial_lr(lr0: float, total_iters: int, power: float = 1.0
                  ) -> Callable[[int], float]:
    """torch ``PolynomialLR`` over epochs: lr0 * (1 - min(e, T) / T) ** power."""

    def schedule(epoch: int) -> float:
        t = min(epoch, total_iters)
        return lr0 * (1.0 - t / total_iters) ** power

    return schedule


@dataclasses.dataclass
class OptimizerBundle:
    """A torch optimizer and its per-epoch learning rate."""

    name: str
    opt: torch.optim.Optimizer
    lr_for_epoch: Callable[[int], float]

    def set_epoch(self, epoch: int) -> float:
        lr = self.lr_for_epoch(epoch)
        for group in self.opt.param_groups:
            group["lr"] = lr
        return lr


def build_optimizer(name: str, params, epochs: int | None = None
                    ) -> OptimizerBundle:
    """Reference optimizer names -> bundle over ``params``."""
    params = list(params)
    if name in ("SGD1", "SGD2"):
        lr0, total = (1e-3, 5) if name == "SGD1" else (6e-3, 20)
        opt = torch.optim.SGD(params, lr=lr0, momentum=0.9,
                              weight_decay=1e-5)
        return OptimizerBundle(name, opt, polynomial_lr(lr0, total))
    if name == "ADAM1":
        if epochs is None:
            raise ValueError("ADAM1's schedule needs the epoch count "
                             "(reference: total_iters=config['epochs'])")
        opt = torch.optim.Adam(params, lr=5e-3, betas=(0.9, 0.999), eps=1e-8)
        return OptimizerBundle(name, opt, polynomial_lr(5e-3, epochs, 2.0))
    raise ValueError(f"Optimizer name not valid: {name!r}")
