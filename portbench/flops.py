"""Model operations counted on the benchmark's plain reference, so that a
share of the peak reads the same work whatever implements it:
``torch.utils.flop_counter.FlopCounterMode`` over the reference's forward
(and, for training, its backward) on the meta device, which computes
nothing and only propagates shapes. Products and convolutions count two
operations a multiply-add; elementwise work is not counted, and nothing
is recomputed."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def count(ref, cfg: dict, shape: tuple, train: bool) -> float:
    """Operations of one forward (with ``train``, forward and backward
    with respect to the parameters) of the reference on (B, H, W, C)
    ``shape`` inputs."""
    specs = ref.param_specs(cfg)
    weights = {}
    for name, shp, kind, _ in specs:
        t = torch.empty(shp, device="meta")
        weights[name] = t.requires_grad_(train and kind not in ("mean",
                                                                "var"))
    x = torch.empty(shape, device="meta")
    with FlopCounterMode(display=False) as counter:
        y = ref.forward(weights, x, cfg, train=train)
        if train:
            y.sum().backward()
    return float(counter.get_total_flops())

