"""Layer helpers with flax numerics on NHWC tensors, and the UNet
``DecodeBlock`` (port of ``cvcs_tpu/models/blocks.py:162-188``), with
BatchNorm in eval and train mode (``blocks.py:35-102``).

Parameters live in ``nn.Conv2d`` / ``nn.LayerNorm`` / ``nn.BatchNorm2d``
holders, so state-dict names are torch's; the arithmetic is written out
here to follow the JAX package: activations stay NHWC and in the compute
dtype of their input, weights are cast to it at use, and normalisations
take f32 statistics and cast back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) along one axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv_nhwc(x, conv: nn.Conv2d, padding="same_flax") -> torch.Tensor:
    """``conv`` on an NHWC tensor in x.dtype. ``padding="same_flax"``
    pads like flax's default ``SAME`` (zero for a stride that divides the
    map); an int pads symmetrically."""
    dt = x.dtype
    y = x.permute(0, 3, 1, 2)          # NCHW view, channels-last strides
    if padding == "same_flax":
        kh, kw = conv.kernel_size
        sh, sw = conv.stride
        top, bottom = _same_pads(y.shape[2], kh, sh)
        left, right = _same_pads(y.shape[3], kw, sw)
        if top or bottom or left or right:
            y = F.pad(y, (left, right, top, bottom))
        padding = 0
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv2d(y, conv.weight.to(dt), bias, conv.stride, padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose_nhwc(x, conv: nn.ConvTranspose2d) -> torch.Tensor:
    """Kernel = stride transposed conv (flax ``nn.ConvTranspose`` with the
    exporter's flipped kernel) on an NHWC tensor in x.dtype."""
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), conv.weight.to(dt), bias,
                           conv.stride)
    return y.permute(0, 2, 3, 1)


def linear(x, layer: nn.Linear) -> torch.Tensor:
    dt = x.dtype
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x, layer.weight.to(dt), bias)


def _affine(xf, mean, var, scale, bias, eps, dt):
    """flax ``_normalize``: (x - mean) * (rsqrt(var + eps) * scale) + bias
    in f32, cast to dt."""
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mean) * mul + bias.float()).to(dt)


def layer_norm(x, norm: nn.LayerNorm) -> torch.Tensor:
    """flax ``nn.LayerNorm``: f32 fast-variance stats over the last axis."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return _affine(xf, mu, var, norm.weight, norm.bias, norm.eps, x.dtype)


def batch_norm_eval(x, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on running statistics over the last (channel) axis."""
    return _affine(x.float(), bn.running_mean, bn.running_var, bn.weight,
                   bn.bias, bn.eps, x.dtype)


BN_MOMENTUM = 0.9    # flax convention: running = 0.9 * running + 0.1 * batch


def batch_norm_train(x, bn: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on batch statistics over the last (channel) axis, the
    JAX package's ``BatchNorm`` in train mode: f32 statistics with flax's
    fast variance max(E[x^2] - E[x]^2, 0), normalisation with that biased
    variance (eps from ``bn``, 1e-5), and the running-stats EMA (momentum
    0.1 in torch's terms) with the running variance updated from the
    UNBIASED variance (factor n / (n - 1)), as torch does."""
    xf = x.float()
    axes = tuple(range(x.dim() - 1))
    mean = xf.mean(axes)
    var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
    with torch.no_grad():
        n = xf.numel() // xf.shape[-1]
        correction = n / max(n - 1, 1)
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean
                              + (1 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var
                             + (1 - BN_MOMENTUM) * var * correction)
    return _affine(xf, mean, var, bn.weight, bn.bias, bn.eps, x.dtype)


class DecodeBlock(nn.Module):
    """2 x [conv3x3 -> ReLU -> BN] (the reference's swapped ReLU/BN order),
    eps 1e-5; BN on batch statistics (updating the running ones) under
    ``train()``, on the running statistics under ``eval()``."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, padding=1)
        self.bn1 = nn.BatchNorm2d(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)
        self.bn2 = nn.BatchNorm2d(features)

    def decode(self, x: torch.Tensor) -> torch.Tensor:
        norm = batch_norm_train if self.training else batch_norm_eval
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = norm(torch.relu(conv_nhwc(x, conv, padding=1)), bn)
        return x

    forward = decode
