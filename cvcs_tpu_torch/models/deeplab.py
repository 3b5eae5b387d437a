"""DeepLabV3: the ASPP head over swappable backbones (port of
``cvcs_tpu/models/deeplab.py``), the zoo's "Resnet101", "Resnet50",
"MobileNet", "MobileNetGoogle" and "MobileNetResnet18".

torchvision's structure: ASPP with a 1x1 branch, atrous 3x3 branches at
rates 12/24/36 and an image-pooling branch (a mean over H and W, a 1x1
conv and a BatchNorm on the (B, 1, 1, 256) map, broadcast back), a 1x1
projection of the five branches with dropout 0.5 (a
:class:`~cvcs_tpu_torch.models.blocks.SeededDropout`), then a 3x3 conv,
BatchNorm, ReLU and the 1x1 classifier. The input is cast to the compute
dtype, and the f32 logits (f64 under an f64 compute dtype) are resized
bilinearly to the input's size.

The ResNet-18 backbone is the reference's experimental swap: the
full-stride trunk, a 2x2 stride-2 transposed conv, ReLU and a 1x1 conv
to 960 channels. Its 1x1 ``aux_layer`` (128 -> 40 over stage 2), like
GoogLeNet's, has parameters but is not run: the head reads ``out``
only. Those parameters get no gradient; the train step still decays
them, as optax does (``train/step.py``).

State-dict names are torchvision's ``deeplabv3_*`` (``backbone.*``,
``classifier.0.convs.4.1``, ``classifier.0.project.0``,
``classifier.4``, ...), the names
``cvcs_tpu.utils.torch_export.export_deeplab`` writes. The ResNet-18
adapter's are ``backbone.upsample``, ``backbone.out_layer`` and
``backbone.aux_layer`` beside torchvision's ``resnet18`` names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.models.blocks import (SeededDropout, at_least_f32,
                                          batch_norm, conv_nhwc,
                                          conv_transpose_nhwc)
from cvcs_tpu_torch.models.googlenet import GoogLeNetBackbone
from cvcs_tpu_torch.models.mobilenet import MobileNetV3Backbone
from cvcs_tpu_torch.models.resnet import (RESNET18, ResNet,
                                          resnet50_backbone,
                                          resnet101_backbone)
from cvcs_tpu_torch.ops.resize import resize_bilinear
from cvcs_tpu_torch.parallel import tp


def _conv_bn_relu(x, conv: nn.Conv2d, bn: nn.BatchNorm2d) -> torch.Tensor:
    y = conv_nhwc(x, conv, padding=conv.padding[0])
    return torch.relu(batch_norm(y, bn))


def phase_conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 3x3 conv at dilation r and padding r on NHWC ``x``, computed as
    a dense 3x3 conv over the r x r phase maps of ``x`` zero-padded to a
    multiple of r (space to batch): the same taps and sums."""
    x = tp.full_channels(x, conv.weight.shape[1])
    r = conv.dilation[0]
    b, h, w, c = x.shape
    hp, wp = -(-h // r) * r, -(-w // r) * r
    x = F.pad(x, (0, 0, 0, wp - w, 0, hp - h))
    x = (x.reshape(b, hp // r, r, wp // r, r, c).permute(0, 2, 4, 1, 3, 5)
         .reshape(b * r * r, hp // r, wp // r, c))
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype), bias, 1, 1)
    y = (y.reshape(b, r, r, -1, hp // r, wp // r).permute(0, 3, 4, 1, 5, 2)
         .reshape(b, -1, hp, wp)[:, :, :h, :w])
    return y.permute(0, 2, 3, 1)


def _atrous_conv_bn_relu(x, conv: nn.Conv2d,
                         bn: nn.BatchNorm2d) -> torch.Tensor:
    """An atrous branch (3x3 at rate r, padding r). A batch of one, as a
    fullconv band gives, runs as :func:`phase_conv`: for such a dilated
    conv at batch 1 cuDNN takes its direct kernel, 1.9-14.7 s a conv at a
    band's stage-4 maps on the H100 where the phase maps take 1.3-5.7
    ms; at the window path's batches cuDNN's dilated conv is the faster,
    2.3-4.2 ms against 4.4-8.6 (``tools/aspp_probe.py``)."""
    if x.shape[0] != 1 or conv.padding[0] != conv.dilation[0]:
        return _conv_bn_relu(x, conv, bn)
    return torch.relu(batch_norm(phase_conv(x, conv), bn))


class ASPP(nn.Module):
    """torchvision's ``ASPP``: ``convs.0`` the 1x1 branch, ``convs.1-3``
    the atrous ones, ``convs.4`` the pooling branch (``.1`` conv, ``.2``
    BN), ``project`` (``.0`` conv, ``.1`` BN, ``.3`` dropout). Index
    slots without parameters hold ``nn.Identity``."""

    def __init__(self, cin: int, features: int = 256,
                 rates=(12, 24, 36), dropout: float = 0.5):
        super().__init__()

        def conv_bn(conv: nn.Conv2d) -> list:
            return [conv, nn.BatchNorm2d(features)]

        self.convs = nn.ModuleList(
            [nn.ModuleList(conv_bn(nn.Conv2d(cin, features, 1, bias=False)))]
            + [nn.ModuleList(conv_bn(nn.Conv2d(cin, features, 3, padding=r,
                                               dilation=r, bias=False)))
               for r in rates]
            + [nn.ModuleList([nn.Identity()] + conv_bn(
                nn.Conv2d(cin, features, 1, bias=False)))])
        self.project = nn.ModuleList(
            conv_bn(nn.Conv2d((len(rates) + 2) * features, features, 1,
                              bias=False)) + [nn.Identity(),
                                              SeededDropout(dropout)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [_conv_bn_relu(x, *self.convs[0])] + [
            _atrous_conv_bn_relu(x, *branch) for branch in self.convs[1:-1]]
        _, conv, bn = self.convs[-1]
        pooled = at_least_f32(x).mean((1, 2), keepdim=True).to(x.dtype)
        pooled = _conv_bn_relu(pooled, conv, bn)
        branches.append(pooled.expand_as(branches[0]))
        y = _conv_bn_relu(torch.cat(branches, dim=-1), *self.project[:2])
        return self.project[3](y)


class DeepLabHead(nn.ModuleList):
    """ASPP -> 3x3 conv (256) -> BN -> ReLU -> 1x1 classifier, at
    torchvision's indices 0, 1, 2, (3), 4."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__([ASPP(cin), nn.Conv2d(256, 256, 3, padding=1,
                                               bias=False),
                          nn.BatchNorm2d(256), nn.Identity(),
                          nn.Conv2d(256, num_classes, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv_bn_relu(self[0](x), self[1], self[2])
        return conv_nhwc(y, self[4], padding=0)


class ResNet18Adapter(ResNet):
    """The full-stride ResNet-18 trunk, then ``upsample`` (2x2 stride-2
    transposed conv) -> ReLU -> ``out_layer`` (1x1 to 960)."""

    def __init__(self, in_channels: int = 3):
        super().__init__(**RESNET18, in_channels=in_channels)
        self.upsample = nn.ConvTranspose2d(512, 512, 2, stride=2)
        self.out_channels = 960
        self.out_layer = nn.Conv2d(512, self.out_channels, 1)
        self.aux_layer = nn.Conv2d(128, 40, 1)      # never run, see above

    def forward(self, x: torch.Tensor) -> dict:
        y = torch.relu(conv_transpose_nhwc(super().forward(x)["out"],
                                           self.upsample))
        return {"out": conv_nhwc(y, self.out_layer, padding=0)}


BACKBONES = {
    "resnet101": resnet101_backbone,
    "resnet50": resnet50_backbone,
    "mobilenet": MobileNetV3Backbone,
    "googlenet": GoogLeNetBackbone,
    "resnet18": ResNet18Adapter,
}


class DeepLabV3(nn.Module):
    """DeepLabV3. Protocol: ``requires_context = False``,
    ``returns_logits = True``. Input NHWC of any dtype (0-255 values, not
    normalised, as in the JAX model), output NHWC f32 logits at the
    input's size; ``dtype`` is the compute dtype, parameters stay f32."""

    requires_context = False
    returns_logits = True

    def __init__(self, num_classes: int, backbone: str = "resnet101",
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if backbone not in BACKBONES:
            raise ValueError(f"unknown DeepLab backbone {backbone!r}; "
                             f"available: {sorted(BACKBONES)}")
        self.backbone_name, self.dtype = backbone, dtype
        self.backbone = BACKBONES[backbone](in_channels=in_channels)
        self.classifier = DeepLabHead(self.backbone.out_channels, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = tuple(x.shape[1:3])
        logits = self.classifier(self.backbone(x.to(self.dtype))["out"])
        return resize_bilinear(at_least_f32(logits), size)
