"""ResNet backbones (port of ``cvcs_tpu/models/resnet.py``): the
torchvision layout (7x7/2 stem, 3x3/2 max pool, four stages; bottleneck
expansion 4), with torchvision's DeepLab recipe of stages 3-4 dilated
instead of strided (output stride 8).

A stage whose stride is replaced by dilation runs its first block at the
*previous* dilation and the later ones at the increased one, as
torchvision's ``_make_layer`` does. The forward returns ``{"out",
"aux", "stage1".."stage4"}`` (out = stage 4, aux = stage 3). State-dict
names are torchvision's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``, ...), the names
``cvcs_tpu.utils.torch_export.export_deeplab`` writes under
``backbone.``.

The TP hook (JAX ``resnet.py:142-144``): under ``parallel/tp.py``
``tensor_parallel`` the last stage's output (2048 channels for the
bottleneck trunks) is held channel-sharded. The bottleneck's sums add
two maps of one width, so both are sharded or both whole.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from cvcs_tpu_torch.models.blocks import batch_norm, conv_nhwc, max_pool_nhwc
from cvcs_tpu_torch.parallel import tp


def _conv_bn(x, conv: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
    return batch_norm(conv_nhwc(x, conv, padding=conv.padding[0]), bn)


class Bottleneck(nn.Module):
    """1x1 reduce -> 3x3 (stride, dilation) -> 1x1 expand x4, with a
    projection shortcut on a change of shape."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        cout = width * self.expansion
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, cout, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(cout)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))
            if cin != cout or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_conv_bn(x, self.conv1, self.bn1))
        y = torch.relu(_conv_bn(y, self.conv2, self.bn2))
        y = _conv_bn(y, self.conv3, self.bn3)
        if self.downsample is not None:
            x = _conv_bn(x, *self.downsample)
        return torch.relu(y + x)


class BasicBlock(nn.Module):
    """Two 3x3 convs (ResNet-18/34)."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.downsample = (nn.Sequential(
            nn.Conv2d(cin, width, 1, stride, bias=False),
            nn.BatchNorm2d(width)) if cin != width or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_conv_bn(x, self.conv1, self.bn1))
        y = _conv_bn(y, self.conv2, self.bn2)
        if self.downsample is not None:
            x = _conv_bn(x, *self.downsample)
        return torch.relu(y + x)


class ResNet(nn.Module):
    """torchvision-layout ResNet trunk; ``replace_stride_with_dilation``
    for stages 2-4 (DeepLab: ``(False, True, True)``)."""

    def __init__(self, stage_sizes: Sequence[int], block: str = "bottleneck",
                 replace_stride_with_dilation: Sequence[bool] = (
                     False, True, True), in_channels: int = 3):
        super().__init__()
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.n_stages = len(stage_sizes)
        cin, dilation = 64, 1
        for stage, n_blocks in enumerate(stage_sizes):
            width = 64 * 2 ** stage
            stride = 1 if stage == 0 else 2
            prev_dilation = dilation
            if stage > 0 and replace_stride_with_dilation[stage - 1]:
                dilation *= stride
                stride = 1
            blocks = []
            for b in range(n_blocks):
                blocks.append(block_cls(
                    cin, width, stride if b == 0 else 1,
                    prev_dilation if b == 0 else dilation))
                cin = width * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.out_channels = cin

    def forward(self, x: torch.Tensor) -> dict:
        x = torch.relu(_conv_bn(x, self.conv1, self.bn1))
        x = max_pool_nhwc(x, 3, 2, padding=1)
        feats = {}
        for stage in range(self.n_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage == self.n_stages - 1:
                x = tp.constrain(x, self.out_channels)
            feats[f"stage{stage + 1}"] = x
        feats["aux"] = feats["stage3"]
        feats["out"] = x
        return feats


def resnet50_backbone(**kw) -> ResNet:
    return ResNet((3, 4, 6, 3), **kw)


def resnet101_backbone(**kw) -> ResNet:
    return ResNet((3, 4, 23, 3), **kw)


# the full-stride ResNet-18 trunk (output stride 32) of the reference's
# experimental DeepLab swap, built by ``deeplab.ResNet18Adapter``
RESNET18 = dict(stage_sizes=(2, 2, 2, 2), block="basic",
                replace_stride_with_dilation=(False, False, False))
