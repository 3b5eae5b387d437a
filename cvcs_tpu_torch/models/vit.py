"""Vision Transformer, DINO's trunks (port of ``cvcs_tpu/models/vit.py``).

The retrieval notebook embeds patches with DINO's torch.hub ViTs
(``dino_vits8/vits16/vitb8/vitb16``). The architecture is here; the
weights are a download, so they come from a DINO ``.pth`` passed as
``load_checkpoint``, a JAX ``.npz`` (``weights.vit_state_dict``), or a
seeded random init.

A pre-LN ViT: a patch-embedding conv (flax ``SAME`` padding, as the JAX
model), a learned CLS token and positional embeddings, blocks of
fused-QKV attention and an exact-GELU MLP, and a final LayerNorm. Every
LayerNorm has eps 1e-5 (DINO's). The attention scores are a product in
the compute dtype divided by sqrt(head dim) rounded to it, the softmax
runs in f32 and is cast back before the second product, as in the JAX
model. For an input whose patch grid differs from the trained grid the
positional embeddings are resized by torch's bicubic filter with DINO's
``scale_factor=(g + 0.1) / pos_grid`` coordinate mapping, as two
matrix products in f32 (:func:`torch_bicubic_matrix`).

Parameter names are DINO's (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
mlp.fc1, mlp.fc2}``, ``norm``), so a DINO hub state dict loads with
``strict=True``. Input NHWC ``(B, H, W, 3)``, already normalised; output
``(CLS embedding f32 (B, dim), patch tokens (B, T, dim))``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.models.blocks import (conv_nhwc, init_weights,
                                          layer_norm, linear, sqrt_in)

LN_EPS = 1e-5                   # torch's LayerNorm default, DINO's


@functools.lru_cache(maxsize=None)
def torch_bicubic_matrix(n_in: int, n_out: int,
                         scale: float | None = None) -> np.ndarray:
    """(n_out, n_in) matrix of torch's ``F.interpolate(mode="bicubic",
    align_corners=False)`` along one axis: cubic convolution with
    A = -0.75, half-pixel centres, edge clamp. ``scale`` maps output to
    input coordinates, ``src = (i + 0.5) * scale - 0.5`` (default
    ``n_in / n_out``, torch's ``size=`` call); DINO passes
    ``scale_factor=(n_out + 0.1) / n_in``, which torch uses as given, so
    DINO's resize is ``scale = n_in / (n_out + 0.1)``."""
    a = -0.75

    def k(x):
        x = abs(x)
        if x <= 1:
            return ((a + 2) * x - (a + 3)) * x * x + 1
        if x < 2:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    m = np.zeros((n_out, n_in), np.float64)
    if scale is None:
        scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        t = src - x0
        for tap, dist in enumerate((t + 1, t, 1 - t, 2 - t)):
            j = min(max(x0 - 1 + tap, 0), n_in - 1)
            m[i, j] += k(dist)
    return m.astype(np.float32)


class ViTBlock(nn.Module):
    """Pre-LN transformer block with DINO's names."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = nn.Module()
        self.attn.qkv = nn.Linear(dim, 3 * dim)
        self.attn.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = nn.Module()
        self.mlp.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.mlp.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        dt, hd = x.dtype, c // self.heads
        qkv = linear(layer_norm(x, self.norm1), self.attn.qkv)
        q, k, v = qkv.reshape(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        scores = torch.matmul(q, k.transpose(-1, -2)) / sqrt_in(hd, dt)
        attn = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, c)
        x = x + linear(out, self.attn.proj)
        y = linear(layer_norm(x, self.norm2), self.mlp.fc1)
        return x + linear(F.gelu(y, approximate="none"), self.mlp.fc2)


class ViT(nn.Module):
    """DINO-compatible ViT trunk; ``forward`` returns (CLS f32, patch
    tokens). ``dtype`` is the compute dtype; parameters stay f32."""

    requires_context = False
    returns_logits = False

    def __init__(self, dim: int = 384, depth: int = 12, heads: int = 6,
                 patch: int = 16, pos_grid: int = 14,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dim, self.depth, self.patch = dim, depth, patch
        self.pos_grid, self.dtype = pos_grid, dtype
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid ** 2 + 1, dim))
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.blocks = nn.ModuleList(ViTBlock(dim, heads)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def _pos_patch(self, gh: int, gw: int) -> torch.Tensor:
        """(1, gh * gw, dim) f32 positional embeddings of the patches."""
        pos = self.pos_embed[:, 1:].float()
        g = self.pos_grid
        if (gh, gw) == (g, g):
            return pos
        dev = pos.device
        wh = torch.from_numpy(torch_bicubic_matrix(g, gh, g / (gh + 0.1)))
        ww = torch.from_numpy(torch_bicubic_matrix(g, gw, g / (gw + 0.1)))
        grid = pos.reshape(g, g, self.dim)
        grid = torch.einsum("oh,hwd->owd", wh.to(dev), grid)
        grid = torch.einsum("ow,hwd->hod", ww.to(dev), grid)
        return grid.reshape(1, gh * gw, self.dim)

    def forward(self, x: torch.Tensor):
        x = conv_nhwc(x.to(self.dtype), self.patch_embed.proj)
        b, gh, gw, _ = x.shape
        tokens = torch.cat([self.cls_token.to(self.dtype).expand(b, 1, -1),
                            x.reshape(b, gh * gw, self.dim)], dim=1)
        pos = torch.cat([self.pos_embed[:, :1].float(),
                         self._pos_patch(gh, gw)], dim=1)
        tokens = tokens + pos.to(self.dtype)
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = layer_norm(tokens, self.norm)
        return tokens[:, 0].float(), tokens[:, 1:]


VIT_VARIANTS = {
    "vits16": dict(dim=384, depth=12, heads=6, patch=16, pos_grid=14),
    "vits8": dict(dim=384, depth=12, heads=6, patch=8, pos_grid=28),
    "vitb16": dict(dim=768, depth=12, heads=12, patch=16, pos_grid=14),
    "vitb8": dict(dim=768, depth=12, heads=12, patch=8, pos_grid=28),
}


def dino_vit(variant: str, seed: int = 0, **kw) -> ViT:
    """The notebook's four DINO trunks by hub-name suffix, seeded-
    initialised as the JAX model initialises: lecun-normal kernels, zero
    biases and CLS token, LayerNorms at identity, positional embeddings
    N(0, 0.02)."""
    if variant not in VIT_VARIANTS:
        raise ValueError(
            f"unknown ViT variant {variant!r}; options: {sorted(VIT_VARIANTS)}")
    model = init_weights(ViT(**VIT_VARIANTS[variant], **kw), seed)
    gen = torch.Generator().manual_seed(seed ^ 0x905)
    with torch.no_grad():
        model.pos_embed.copy_(
            torch.randn(model.pos_embed.shape, generator=gen) * 0.02)
    return model
