"""GoogLeNet (Inception v1) trunk, the reference's experimental DeepLab
backbone (port of ``cvcs_tpu/models/googlenet.py``): torchvision's
``googlenet`` cut after inception4e (832 channels, stride 16), then the
reference's 1x1 ``out_layer`` to 960 channels, the channel count of the
MobileNet DeepLab head.

torchvision's conventions: ``BasicConv2d`` is a conv without bias, a
BatchNorm with eps 1e-3 and a ReLU; an inception's third branch is a 3x3;
the stage max pools are 3x3 stride 2 with ``ceil_mode`` (the bottom and
right edges padded with -inf until the last window fits).

The reference's ``aux_layer`` (1x1, 192 -> 40 over the post-pool stem)
has parameters but is not run: the DeepLab head reads ``out`` only.
State-dict names are torchvision's (``conv1.conv``,
``inception3a.branch2.1.bn``, ...) plus ``out_layer`` and ``aux_layer``,
the names ``cvcs_tpu.utils.torch_import.import_googlenet`` reads.
"""

from __future__ import annotations

import torch
from torch import nn

from cvcs_tpu_torch.models.blocks import batch_norm, conv_nhwc, max_pool_nhwc


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 padding: int = 0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_nhwc(x, self.conv, padding=self.conv.padding[0])
        return torch.relu(batch_norm(y, self.bn))


def _ceil_maxpool(x: torch.Tensor) -> torch.Tensor:
    return max_pool_nhwc(x, 3, 2, ceil_mode=True)


class Inception(nn.Module):
    """1x1 | 1x1 -> 3x3 | 1x1 -> 3x3 | 3x3/1 max pool -> 1x1, concatenated
    (``branch4.0`` is torchvision's parameterless pool)."""

    def __init__(self, cin: int, ch1: int, ch3red: int, ch3: int,
                 ch5red: int, ch5: int, pool_proj: int):
        super().__init__()
        self.branch1 = BasicConv2d(cin, ch1)
        self.branch2 = nn.Sequential(BasicConv2d(cin, ch3red),
                                     BasicConv2d(ch3red, ch3, 3, padding=1))
        self.branch3 = nn.Sequential(BasicConv2d(cin, ch5red),
                                     BasicConv2d(ch5red, ch5, 3, padding=1))
        self.branch4 = nn.Sequential(nn.Identity(),
                                     BasicConv2d(cin, pool_proj))
        self.out_channels = ch1 + ch3 + ch5 + pool_proj

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pooled = max_pool_nhwc(x, 3, 1, padding=1)
        return torch.cat([self.branch1(x), self.branch2(x), self.branch3(x),
                          self.branch4[1](pooled)], dim=-1)


# (ch1, ch3red, ch3, ch5red, ch5, pool_proj) per torchvision googlenet
_INCEPTION_3 = {"inception3a": (64, 96, 128, 16, 32, 32),
                "inception3b": (128, 128, 192, 32, 96, 64)}
_INCEPTION_4 = {"inception4a": (192, 96, 208, 16, 48, 64),
                "inception4b": (160, 112, 224, 24, 64, 64),
                "inception4c": (128, 128, 256, 24, 64, 64),
                "inception4d": (112, 144, 288, 32, 64, 64),
                "inception4e": (256, 160, 320, 32, 128, 128)}


class GoogLeNetBackbone(nn.Module):
    """Truncated GoogLeNet with the reference's adapter convs;
    ``{"out": 960 channels at stride 16}``."""

    out_channels = 960

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = BasicConv2d(in_channels, 64, 7, 2, 3)
        self.conv2 = BasicConv2d(64, 64)
        self.conv3 = BasicConv2d(64, 192, 3, padding=1)
        cin = 192
        for name, cfg in {**_INCEPTION_3, **_INCEPTION_4}.items():
            self.add_module(name, Inception(cin, *cfg))
            cin = getattr(self, name).out_channels
        self.out_layer = nn.Conv2d(cin, self.out_channels, 1)
        self.aux_layer = nn.Conv2d(192, 40, 1)      # never run, see above

    def forward(self, x: torch.Tensor) -> dict:
        x = _ceil_maxpool(self.conv1(x))
        x = _ceil_maxpool(self.conv3(self.conv2(x)))
        for name in _INCEPTION_3:
            x = getattr(self, name)(x)
        x = _ceil_maxpool(x)
        for name in _INCEPTION_4:
            x = getattr(self, name)(x)
        return {"out": conv_nhwc(x, self.out_layer, padding=0)}
