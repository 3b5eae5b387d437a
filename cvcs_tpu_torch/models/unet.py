"""The UNet family, "Unet", "Unetv2" and "Unetv2S2D" (port of
``cvcs_tpu/models/unet.py``).

A 5-level encoder (64 -> 128 -> 256 -> 512 -> 1024 channels, two
conv-BN-ReLU blocks per level, 2x2 max pool between levels) and a
skip-concat decoder. ``upsample="bilinear"`` ("Unet") upsamples with a 2x
bilinear resize and a conv3x3 halving channels; ``upsample="transpose"``
("Unetv2", the serve and train recipes' model) with a k = s = 2
transposed conv. ``stem="s2d"`` ("Unetv2S2D") rearranges the input 2x
space-to-depth, runs every level at half resolution, and emits 4x the
classes rearranged back depth-to-space.

Public layout follows the JAX model: NHWC input of any dtype, NHWC f32
logits; activations in the compute dtype (bf16 by default), parameters in
f32. State-dict names are the reference's (``encode{1..5}``,
``upscale{1..4}``, ``decode_forward{1..4}``), so what
``cvcs_tpu.utils.torch_export.export_unet`` writes loads with
``strict=True``. The decoder concatenates skip-first at every level but
the third, which center-crops the upsampled map to the skip's size and
puts it first (``unet.py:146-152``).

``remat=True`` rematerialises the encoder's conv-BN-ReLU blocks in the
backward (:class:`~cvcs_tpu_torch.models.blocks.ConvBNAct`); the decoder
is not rematerialised, as in the JAX model.
"""

from __future__ import annotations

import torch
from torch import nn

from cvcs_tpu_torch.models.blocks import (ConvBNAct, UpscaleBlock,
                                          center_crop, conv_nhwc,
                                          conv_transpose_nhwc, decode,
                                          max_pool_nhwc)

ENCODER_WIDTHS = (64, 128, 256, 512, 1024)


def space_to_depth(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def depth_to_space(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r))
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, c // (r * r))


class _DecodeLayer(nn.Module):
    """The reference's ``UnetForwardDecodeLayer``: ``layer.{0,2,3,5}`` are
    conv, BN, conv, BN; 1 and 4 the ReLUs."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.layer = nn.ModuleList([
            nn.Conv2d(cin, features, 3, padding=1), nn.ReLU(),
            nn.BatchNorm2d(features),
            nn.Conv2d(features, features, 3, padding=1), nn.ReLU(),
            nn.BatchNorm2d(features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lay = self.layer
        return decode(x, ((lay[0], lay[2]), (lay[3], lay[5])))


class UNet(nn.Module):
    """5-level U-Net. Protocol: ``requires_context = False``,
    ``returns_logits = True``. ``dtype`` is the compute dtype; parameters
    stay float32."""

    requires_context = False
    returns_logits = True

    def __init__(self, num_classes: int, upsample: str = "bilinear",
                 stem: str = "full", in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16, remat: bool = False):
        super().__init__()
        if upsample not in ("bilinear", "transpose"):
            raise ValueError(f"upsample must be 'bilinear' or 'transpose', "
                             f"got {upsample!r}")
        if stem not in ("full", "s2d"):
            raise ValueError(f"stem must be 'full' or 's2d', got {stem!r}")
        self.upsample, self.stem, self.dtype = upsample, stem, dtype
        cin = in_channels * 4 if stem == "s2d" else in_channels
        for level, width in enumerate(ENCODER_WIDTHS):
            blocks = [ConvBNAct(cin, width, remat=remat),
                      ConvBNAct(width, width, remat=remat)]
            if level > 0:                   # index 0: the reference's pool
                blocks.insert(0, nn.MaxPool2d(2))
            setattr(self, f"encode{level + 1}", nn.ModuleList(blocks))
            cin = width
        for j, width in enumerate(reversed(ENCODER_WIDTHS[:-1])):
            up = (nn.ConvTranspose2d(2 * width, width, 2, stride=2)
                  if upsample == "transpose" else UpscaleBlock(2 * width))
            setattr(self, f"upscale{j + 1}", nn.ModuleList([up]))
            dec = [_DecodeLayer(2 * width, width)]
            if j == 3:
                out = num_classes * 4 if stem == "s2d" else num_classes
                dec.append(nn.Conv2d(width, out, 1))
            setattr(self, f"decode_forward{j + 1}", nn.ModuleList(dec))

    def _up(self, j: int, y: torch.Tensor) -> torch.Tensor:
        up = getattr(self, f"upscale{j + 1}")[0]
        if self.upsample == "transpose":
            return conv_transpose_nhwc(y, up)
        return up(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        feats = []
        for level in range(len(ENCODER_WIDTHS)):
            if level > 0:
                x = max_pool_nhwc(x)
            for blk in getattr(self, f"encode{level + 1}")[-2:]:
                x = blk(x)
            feats.append(x)
        x1, x2, x3, x4, y = feats
        y = self.decode_forward1[0](torch.cat([x4, self._up(0, y)], -1))
        y = self.decode_forward2[0](torch.cat([x3, self._up(1, y)], -1))
        y = center_crop(self._up(2, y), (x2.shape[1], x2.shape[2]))
        y = self.decode_forward3[0](torch.cat([y, x2], -1))
        y = self.decode_forward4[0](torch.cat([x1, self._up(3, y)], -1))
        logits = conv_nhwc(y, self.decode_forward4[1])
        if self.stem == "s2d":
            logits = depth_to_space(logits, 2)
        return logits.float()


def unet(num_classes: int, **kw) -> UNet:
    """The reference's "Unet"."""
    return UNet(num_classes, upsample="bilinear", **kw)


def unet_v2(num_classes: int, **kw) -> UNet:
    """The reference's "Unetv2"."""
    return UNet(num_classes, upsample="transpose", **kw)
