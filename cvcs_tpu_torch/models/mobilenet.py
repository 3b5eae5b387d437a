"""MobileNetV3-Large backbone, dilated (port of
``cvcs_tpu/models/mobilenet.py``): torchvision's
``_mobilenet_v3_conf("mobilenet_v3_large", dilated=True)``.

A block whose config has dilation > 1 runs at stride 1 (output stride
16), but its residual is gated on the *config's* stride, as torchvision
gates it: the stride-2 dilated block gains no skip. Activations are ReLU
or hardswish, the squeeze-excitation gate hardsigmoid with
``_make_divisible(expanded // 4)`` squeeze channels (flax's
``hard_swish``/``hard_sigmoid`` are ``F.hardswish``/``F.hardsigmoid``).
Every BatchNorm has eps 1e-3 and momentum 0.01 (the JAX 0.99).

The forward returns ``{"out"}``: the 960-channel last conv at stride 16.
The 40-channel ``aux`` tap is not returned, since the DeepLab head never
reads it. State-dict names are torchvision's ``features`` indices
(``0.0``, ``1.block.0.0``, ``4.block.2.fc1``, ``16.1``, ...), the names
``cvcs_tpu.utils.torch_export.export_deeplab`` writes under
``backbone.``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.models.blocks import at_least_f32, batch_norm, conv_nhwc

BN_EPS, BN_MOMENTUM = 1e-3, 0.01       # torch's terms


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    kernel: int
    expanded: int
    out: int
    use_se: bool
    use_hs: bool   # hardswish (else ReLU)
    stride: int
    dilation: int = 1


LARGE_DILATED: Sequence[BlockCfg] = (
    BlockCfg(3, 16, 16, False, False, 1),
    BlockCfg(3, 64, 24, False, False, 2),
    BlockCfg(3, 72, 24, False, False, 1),
    BlockCfg(5, 72, 40, True, False, 2),
    BlockCfg(5, 120, 40, True, False, 1),
    BlockCfg(5, 120, 40, True, False, 1),
    BlockCfg(3, 240, 80, False, True, 2),
    BlockCfg(3, 200, 80, False, True, 1),
    BlockCfg(3, 184, 80, False, True, 1),
    BlockCfg(3, 184, 80, False, True, 1),
    BlockCfg(3, 480, 112, True, True, 1),
    BlockCfg(3, 672, 112, True, True, 1),
    BlockCfg(5, 672, 160, True, True, 2, 2),
    BlockCfg(5, 960, 160, True, True, 1, 2),
    BlockCfg(5, 960, 160, True, True, 1, 2),
)


def _conv_bn(cin: int, cout: int, kernel: int = 1, stride: int = 1,
             dilation: int = 1, groups: int = 1) -> nn.ModuleList:
    """torchvision's ``Conv2dNormActivation`` parameters: ``0`` the conv,
    ``1`` the BatchNorm (the activation has none)."""
    return nn.ModuleList([
        nn.Conv2d(cin, cout, kernel, stride, padding=(kernel // 2) * dilation,
                  dilation=dilation, groups=groups, bias=False),
        nn.BatchNorm2d(cout, eps=BN_EPS, momentum=BN_MOMENTUM)])


def _run_conv_bn(x, layer: nn.ModuleList) -> torch.Tensor:
    conv, bn = layer
    return batch_norm(conv_nhwc(x, conv, padding=conv.padding[0]), bn)


def _mean_hw(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W, summed in f32 as ``jnp.mean`` sums a bf16 map."""
    return at_least_f32(x).mean((1, 2), keepdim=True).to(x.dtype)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, squeeze: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, squeeze, 1)
        self.fc2 = nn.Conv2d(squeeze, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.relu(conv_nhwc(_mean_hw(x), self.fc1, padding=0))
        return x * F.hardsigmoid(conv_nhwc(s, self.fc2, padding=0))


class InvertedResidual(nn.Module):
    """[1x1 expand] -> k x k depthwise (stride or dilation) -> [SE] -> 1x1
    project, under torchvision's ``block.{k}`` names."""

    def __init__(self, cfg: BlockCfg, cin: int):
        super().__init__()
        stride = 1 if cfg.dilation > 1 else cfg.stride
        layers = []
        if cfg.expanded != cin:
            layers.append(_conv_bn(cin, cfg.expanded))
        layers.append(_conv_bn(cfg.expanded, cfg.expanded, cfg.kernel, stride,
                               cfg.dilation, groups=cfg.expanded))
        if cfg.use_se:
            layers.append(SqueezeExcite(cfg.expanded,
                                        _make_divisible(cfg.expanded // 4)))
        layers.append(_conv_bn(cfg.expanded, cfg.out))
        self.block = nn.ModuleList(layers)
        self.act = F.hardswish if cfg.use_hs else torch.relu
        self.residual = cfg.stride == 1 and cin == cfg.out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for layer in self.block[:-1]:
            if isinstance(layer, SqueezeExcite):
                y = layer(y)
            else:
                y = self.act(_run_conv_bn(y, layer))
        y = _run_conv_bn(y, self.block[-1])
        return y + x if self.residual else y


class MobileNetV3Backbone(nn.ModuleList):
    """MobileNetV3-Large dilated trunk: ``0`` the stem, ``1``-``15`` the
    blocks, ``16`` the 960-channel last conv."""

    def __init__(self, in_channels: int = 3):
        layers = [_conv_bn(in_channels, 16, 3, 2)]
        cin = 16
        for cfg in LARGE_DILATED:
            layers.append(InvertedResidual(cfg, cin))
            cin = cfg.out
        layers.append(_conv_bn(cin, 6 * cin))
        super().__init__(layers)
        self.out_channels = 6 * cin                         # 960

    def forward(self, x: torch.Tensor) -> dict:
        x = F.hardswish(_run_conv_bn(x, self[0]))
        for block in list(self)[1:-1]:
            x = block(x)
        return {"out": F.hardswish(_run_conv_bn(x, self[-1]))}
