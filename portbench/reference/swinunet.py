"""Plain float32 reference of the ``swinunet`` configuration: a Swin-T
encoder (Liu et al., arXiv:2103.14030: embed 96, depths 2/2/6/2, heads
3/6/12/24, MLP ratio 4, patch 4) under a U-Net decoder.

- Patch embedding: a 4x4/4 convolution, then LayerNorm.
- Stage s > 0 opens with patch merging as a 2x2/2 convolution without
  bias, then LayerNorm (the paper normalises the concatenated 2x2
  neighbours before its linear projection).
- Block: x + W-MSA(LN(x)), then x + MLP(LN(x)) (GELU, exact). Windows
  of ``window`` tokens a side, clamped to the map; every second block
  of a stage is shifted by half a window, unless the map is a single
  window. A map that is not a multiple of the window is zero-padded at
  its bottom and right and the pad tokens are masked as keys. LayerNorm
  eps is 1e-6.
- Decoder (no published source; the configuration lists it as
  assumed): from the last stage up, a k = s = 2 transposed convolution,
  concatenation after the skip of the stage below, and two [3x3 conv ->
  ReLU -> BatchNorm]; a head of two k = s = 2 transposed convolutions
  with ReLU and a 3x3 convolution to the classes.

Departures from the paper, listed in the configuration as assumed: the
window is 8 (the paper's 7), so windows tile the 64 x 64 tokens of a
256-pixel window; there is no relative position bias. Parameters are
named as the repository's torch twin of the model names them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import ops
from portbench.reference.unetv2 import _bn, _conv

LN_EPS = 1e-6


def _ln(name, c):
    return [(f"{name}.weight", (c,), "norm_w", 0),
            (f"{name}.bias", (c,), "norm_b", 0)]


def _linear(name, cout, cin):
    return [(f"{name}.weight", (cout, cin), "weight", cin),
            (f"{name}.bias", (cout,), "bias", 0)]


def param_specs(cfg: dict) -> list[tuple]:
    """(name, shape, kind, fan-in) of every float parameter and buffer."""
    dims, depths, pt = cfg["dims"], cfg["depths"], cfg["patch"]
    r = cfg["mlp_ratio"]
    specs = _conv("patch_embed.proj", dims[0], cfg["in_channels"], pt)
    specs += _ln("patch_embed.norm", dims[0])
    for s, c in enumerate(dims):
        if s:
            specs.append((f"layers.{s}.downsample.proj.weight",
                          (c, dims[s - 1], 2, 2), "weight", dims[s - 1] * 4))
            specs += _ln(f"layers.{s}.downsample.norm", c)
        for d in range(depths[s]):
            b = f"layers.{s}.blocks.{d}"
            specs += _ln(f"{b}.norm1", c)
            specs += _linear(f"{b}.attn.qkv", 3 * c, c)
            specs += _linear(f"{b}.attn.proj", c, c)
            specs += _ln(f"{b}.norm2", c)
            specs += _linear(f"{b}.mlp.fc1", r * c, c)
            specs += _linear(f"{b}.mlp.fc2", c, r * c)
    for i, s in enumerate(range(len(dims) - 2, -1, -1)):
        cin, c = dims[s + 1], dims[s]
        specs += _conv(f"decoder.{i}.conv1", c, 2 * c, 3)
        specs += _bn(f"decoder.{i}.bn1", c)
        specs += _conv(f"decoder.{i}.conv2", c, c, 3)
        specs += _bn(f"decoder.{i}.bn2", c)
        specs += [(f"decoder.{i}.up.weight", (cin, c, 2, 2), "weight", cin),
                  (f"decoder.{i}.up.bias", (c,), "bias", 0)]
    h = dims[0] // 2
    specs += [("head.up1.weight", (dims[0], h, 2, 2), "weight", dims[0]),
              ("head.up1.bias", (h,), "bias", 0),
              ("head.up2.weight", (h, h, 2, 2), "weight", h),
              ("head.up2.bias", (h,), "bias", 0)]
    specs += _conv("head.out", cfg["num_classes"], h, 3)
    return specs


def _block(p, b, x, heads, window, shifted, prec):
    """One Swin block on (B, H, W, C) tokens."""
    bsz, h0, w0, c = x.shape
    win = min(window, h0, w0)
    shift = win // 2 if shifted and win > 1 and min(h0, w0) > win else 0
    y = ops.layer_norm(x, p[f"{b}.norm1.weight"], p[f"{b}.norm1.bias"],
                       LN_EPS)
    ph, pw = -h0 % win, -w0 % win
    y = F.pad(y, (0, 0, 0, pw, 0, ph))
    h, w = h0 + ph, w0 + pw
    y = torch.roll(y, (-shift, -shift), (1, 2))
    mask = ops.shifted_window_mask(h0, w0, win, shift, x.device)
    y = ops.window_attention(
        ops.windows(y, win), mask, p[f"{b}.attn.qkv.weight"],
        p[f"{b}.attn.qkv.bias"], p[f"{b}.attn.proj.weight"],
        p[f"{b}.attn.proj.bias"], heads, prec)
    y = torch.roll(ops.unwindows(y, win, bsz, h, w), (shift, shift), (1, 2))
    x = x + y[:, :h0, :w0]
    z = ops.layer_norm(x, p[f"{b}.norm2.weight"], p[f"{b}.norm2.bias"],
                       LN_EPS)
    z = F.gelu(ops.linear(z, p[f"{b}.mlp.fc1.weight"], p[f"{b}.mlp.fc1.bias"],
                          prec))
    return x + ops.linear(z, p[f"{b}.mlp.fc2.weight"], p[f"{b}.mlp.fc2.bias"],
                          prec)


def forward(p: dict, x: torch.Tensor, cfg: dict, train: bool = False,
            prec: str = "f32") -> torch.Tensor:
    """(B, H, W, C) float32 images (0-255, not normalised) -> (B, H, W,
    classes) float32 logits; ``train`` runs the decoder's BatchNorm on
    batch statistics."""
    dims, depths, heads = cfg["dims"], cfg["depths"], cfg["heads"]
    pt = cfg["patch"]
    y = ops.conv_nhwc(x, p["patch_embed.proj.weight"],
                      p["patch_embed.proj.bias"], pt, 0, prec)
    y = ops.layer_norm(y, p["patch_embed.norm.weight"],
                       p["patch_embed.norm.bias"], LN_EPS)
    skips = []
    for s in range(len(dims)):
        if s:
            y = ops.conv_nhwc(y, p[f"layers.{s}.downsample.proj.weight"],
                              None, 2, 0, prec)
            y = ops.layer_norm(y, p[f"layers.{s}.downsample.norm.weight"],
                               p[f"layers.{s}.downsample.norm.bias"], LN_EPS)
        for d in range(depths[s]):
            y = _block(p, f"layers.{s}.blocks.{d}", y, heads[s],
                       cfg["window"], bool(d % 2), prec)
        skips.append(y)
    y = skips[-1]

    def decode(y, name):
        y = ops.conv_nhwc(y, p[f"{name}.conv1.weight"], p[f"{name}.conv1.bias"],
                          1, 1, prec)
        y = ops.batch_norm_nhwc(torch.relu(y), p[f"{name}.bn1.weight"],
                                p[f"{name}.bn1.bias"],
                                p[f"{name}.bn1.running_mean"],
                                p[f"{name}.bn1.running_var"], train)
        y = ops.conv_nhwc(y, p[f"{name}.conv2.weight"], p[f"{name}.conv2.bias"],
                          1, 1, prec)
        return ops.batch_norm_nhwc(torch.relu(y), p[f"{name}.bn2.weight"],
                                   p[f"{name}.bn2.bias"],
                                   p[f"{name}.bn2.running_mean"],
                                   p[f"{name}.bn2.running_var"], train)

    for i, s in enumerate(range(len(dims) - 2, -1, -1)):
        up = ops.conv_t_nhwc(y, p[f"decoder.{i}.up.weight"],
                             p[f"decoder.{i}.up.bias"], 2, prec)
        y = decode(torch.cat([skips[s], up], -1), f"decoder.{i}")
    y = torch.relu(ops.conv_t_nhwc(y, p["head.up1.weight"], p["head.up1.bias"],
                                   2, prec))
    y = torch.relu(ops.conv_t_nhwc(y, p["head.up2.weight"], p["head.up2.bias"],
                                   2, prec))
    return ops.conv_nhwc(y, p["head.out.weight"], p["head.out.bias"], 1, 1,
                         prec)
