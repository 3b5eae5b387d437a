"""Plain float32 reference of the ``unetv2`` configuration: U-Net
(Ronneberger et al., arXiv:1505.04597) as the CVCS reference's
"Unetv2" builds it.

- Encoder: five levels of widths 64-1024, each two [3x3 conv (padding
  1) -> BatchNorm -> ReLU], a 2x2/2 max pool before every level but the
  first.
- Decoder: four levels, each a k = s = 2 transposed convolution halving
  the channels, a concatenation with the encoder's skip (skip first,
  except at the third level, where the upsampled map is centre-cropped
  to the skip and goes first, as the reference's ``unet.py`` does), and
  two [3x3 conv -> ReLU -> BatchNorm] (the reference's ReLU/BN order).
- A 1x1 convolution to the classes.

Departures from the paper: padded convolutions (the output keeps the
input's size) and BatchNorm, as the reference has them. Parameters are
named as the reference's state dict names them (``encode{1..5}``,
``upscale{1..4}``, ``decode_forward{1..4}``).
"""

from __future__ import annotations

import torch

from portbench.reference import ops


def _conv(name, cout, cin, k):
    return [(f"{name}.weight", (cout, cin, k, k), "weight", cin * k * k),
            (f"{name}.bias", (cout,), "bias", 0)]


def _bn(name, c):
    return [(f"{name}.weight", (c,), "norm_w", 0),
            (f"{name}.bias", (c,), "norm_b", 0),
            (f"{name}.running_mean", (c,), "mean", 0),
            (f"{name}.running_var", (c,), "var", 0)]


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, kind, fan-in) of every float parameter and buffer."""
    widths = cfg["encoder_widths"]
    specs, cin = [], cfg["in_channels"]
    for level, w in enumerate(widths):
        first = 0 if level == 0 else 1         # index 0 of deeper levels: the pool
        for i in (first, first + 1):
            specs += _conv(f"encode{level + 1}.{i}.layer.0", w, cin, 3)
            specs += _bn(f"encode{level + 1}.{i}.layer.1", w)
            cin = w
    for j, w in enumerate(reversed(widths[:-1])):
        specs += [(f"upscale{j + 1}.0.weight", (2 * w, w, 2, 2), "weight",
                   2 * w),
                  (f"upscale{j + 1}.0.bias", (w,), "bias", 0)]
        specs += _conv(f"decode_forward{j + 1}.0.layer.0", w, 2 * w, 3)
        specs += _bn(f"decode_forward{j + 1}.0.layer.2", w)
        specs += _conv(f"decode_forward{j + 1}.0.layer.3", w, w, 3)
        specs += _bn(f"decode_forward{j + 1}.0.layer.5", w)
    specs += _conv("decode_forward4.1", cfg["num_classes"], widths[0], 1)
    return specs


def forward(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
            prec: str = "f32") -> torch.Tensor:
    """(B, H, W, C) float32 images (0-255, not normalised) -> (B, H, W,
    classes) float32 logits; ``train`` normalises with batch statistics."""
    def bn(y, name):
        return ops.batch_norm(y, p[f"{name}.weight"], p[f"{name}.bias"],
                              p[f"{name}.running_mean"],
                              p[f"{name}.running_var"], train)

    def conv3(y, name):
        return ops.conv(y, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1, prec)

    widths = cfg["encoder_widths"]
    y = x.permute(0, 3, 1, 2)
    feats = []
    for level in range(len(widths)):
        first = 0 if level == 0 else 1
        if level:
            y = ops.max_pool2(y)
        for i in (first, first + 1):
            name = f"encode{level + 1}.{i}.layer"
            y = torch.relu(bn(conv3(y, f"{name}.0"), f"{name}.1"))
        feats.append(y)
    y = feats[-1]
    for j in range(len(widths) - 1):
        skip = feats[-2 - j]
        y = ops.conv_t(y, p[f"upscale{j + 1}.0.weight"],
                       p[f"upscale{j + 1}.0.bias"], 2, prec)
        if j == 2:
            y = torch.cat([ops.center_crop(y, skip.shape[2], skip.shape[3]),
                           skip], 1)
        else:
            y = torch.cat([skip, y], 1)
        name = f"decode_forward{j + 1}.0.layer"
        y = bn(torch.relu(conv3(y, f"{name}.0")), f"{name}.2")
        y = bn(torch.relu(conv3(y, f"{name}.3")), f"{name}.5")
    y = ops.conv(y, p["decode_forward4.1.weight"], p["decode_forward4.1.bias"],
                 1, 0, prec)
    return y.permute(0, 2, 3, 1)
