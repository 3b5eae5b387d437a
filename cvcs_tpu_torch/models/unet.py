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

On row strips (``core/mesh.py`` ``spatial_parallel``) every level runs
on the rank's rows (``models/blocks.py``: the 3x3 convs take a one-row
halo, the 2x2 pools and transposed convs are local). A level whose
strip has an odd number of rows cannot be pooled locally: its map is
gathered and the deeper levels run whole on every rank
(``core/mesh.py`` ``whole_rows``), and the decoder splits the upsampled
map again where it meets a skip held in strips. ``space_to_depth`` and
``depth_to_space`` are local on even strips.

The TP hook (JAX ``unet.py:117-120``): under ``parallel/tp.py``
``tensor_parallel`` the 1024-channel bottleneck is held channel-sharded,
and the decoder's concatenations gather the sharded maps first.
"""

from __future__ import annotations

import torch
from torch import nn

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.models.blocks import (ConvBNAct, UpscaleBlock,
                                          center_crop, conv_nhwc,
                                          conv_transpose_nhwc, decode,
                                          max_pool_nhwc)
from cvcs_tpu_torch.parallel import halo, tp

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
        sp = mesh_lib.strip_mesh()
        whole = False
        if self.stem == "s2d":
            if sp is not None and x.shape[1] % 2:
                x, whole = halo.gather_rows(x, sp, "space_to_depth",
                                            "odd strips"), True
            x = space_to_depth(x, 2)
        feats = []
        for level in range(len(ENCODER_WIDTHS)):
            if level > 0:
                if sp is not None and not whole and x.shape[1] % 2:
                    x = halo.gather_rows(
                        x, sp, f"max pool after level {level}",
                        "odd strips")
                    whole = True
                with mesh_lib.whole_rows(whole):
                    x = max_pool_nhwc(x)
            with mesh_lib.whole_rows(whole):
                for blk in getattr(self, f"encode{level + 1}")[-2:]:
                    x = blk(x)
            feats.append((x, whole))
        (y, whole), skips = feats[-1], feats[-2::-1]
        y = tp.constrain(y, ENCODER_WIDTHS[-1])
        for j, (skip, skip_whole) in enumerate(skips):
            with mesh_lib.whole_rows(whole):
                y = self._up(j, y)
            if whole and not skip_whole:
                y, whole = halo.split_rows(y, sp), False
            width = ENCODER_WIDTHS[-2 - j]
            skip, y = tp.full_channels(skip, width), tp.full_channels(y, width)
            with mesh_lib.whole_rows(whole):
                if j == 2:
                    y = center_crop(y, (skip.shape[1], skip.shape[2]))
                    y = torch.cat([y, skip], -1)
                else:
                    y = torch.cat([skip, y], -1)
                y = getattr(self, f"decode_forward{j + 1}")[0](y)
        with mesh_lib.whole_rows(whole):
            logits = conv_nhwc(y, self.decode_forward4[1])
        if self.stem == "s2d":
            logits = depth_to_space(logits, 2)
        if whole:
            logits = halo.split_rows(logits, sp)
        return logits.float()


def unet(num_classes: int, **kw) -> UNet:
    """The reference's "Unet"."""
    return UNet(num_classes, upsample="bilinear", **kw)


def unet_v2(num_classes: int, **kw) -> UNet:
    """The reference's "Unetv2"."""
    return UNet(num_classes, upsample="transpose", **kw)
