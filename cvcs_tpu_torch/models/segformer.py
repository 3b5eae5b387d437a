"""SegFormer: the MiT encoder, the all-MLP decode head and the
reference's learned 4x tail (port of ``cvcs_tpu/models/segformer.py``).

"SegformerMod" is MiT-B3 (depths 3/4/18/3, widths 64/128/320/512, heads
1/2/5/8, spatial-reduction ratios 8/4/2/1, decoder 768). The encoder has
four stages, each an overlapped patch embedding (7x7 stride 4, then 3x3
stride 2) with a LayerNorm, blocks of efficient self-attention (K/V from
a VALID kernel = stride = sr conv and a LayerNorm; the tokens themselves
at sr 1) and a Mix-FFN (fc1, 3x3 depthwise conv, exact GELU, fc2), and a
LayerNorm at its end. The head projects each stage to ``decoder_dim``,
resizes it bilinearly to stage 1's size, concatenates in reversed stage
order, fuses by a 1x1 conv, BatchNorm and ReLU, drops out at 0.1 and
classifies; the tail (``ConvT(8, s2, p3)``, ReLU, ``ConvT(4, s2, p1)``,
ReLU, conv3x3) brings the 1/4-scale logits to the input's size.

Every LayerNorm is flax's default, eps 1e-6. The attention scores are
formed in the compute dtype and divided by sqrt(head dim) rounded to it,
the softmax runs in f32 and is cast back before the second product, as
in the JAX model. ``paper_normalization`` applies the ImageNet mean and
std to raw 0-255 values (the reference's quirk); off, the input is first
scaled by 1/255. Only the first three bands are read, so a 4-band input
works (``in_channels`` is accepted and ignored).

State-dict names are Hugging Face's ``SegformerForSemanticSegmentation``
plus the reference's ``seq`` tail, the names
``cvcs_tpu.utils.torch_export.export_segformer`` writes, so its output
loads with ``strict=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.models.blocks import (SeededDropout, batch_norm,
                                          conv_nhwc, conv_transpose_nhwc,
                                          layer_norm, linear, sqrt_in)
from cvcs_tpu_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LN_EPS = 1e-6                    # flax's LayerNorm default


@dataclasses.dataclass(frozen=True)
class MiTConfig:
    depths: Sequence[int]
    hidden_sizes: Sequence[int]
    num_heads: Sequence[int]
    sr_ratios: Sequence[int] = (8, 4, 2, 1)
    mlp_ratio: int = 4
    decoder_dim: int = 768


MIT_B0 = MiTConfig((2, 2, 2, 2), (32, 64, 160, 256), (1, 2, 5, 8),
                   decoder_dim=256)
MIT_B1 = MiTConfig((2, 2, 2, 2), (64, 128, 320, 512), (1, 2, 5, 8))
MIT_B3 = MiTConfig((3, 4, 18, 3), (64, 128, 320, 512), (1, 2, 5, 8))


class _SelfAttention(nn.Module):
    """HF ``attention.self``: query, key, value, and at sr > 1 the K/V
    reduction conv ``sr`` with its ``layer_norm``."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.layer_norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        dt = x.dtype
        q = linear(x, self.query)
        if self.sr_ratio > 1:
            kv = conv_nhwc(x.reshape(b, hw[0], hw[1], c), self.sr, padding=0)
            kv = layer_norm(kv.reshape(b, -1, c), self.layer_norm)
        else:
            kv = x
        hd = c // self.heads
        q = q.reshape(b, n, self.heads, hd).transpose(1, 2)
        k = linear(kv, self.key).reshape(b, -1, self.heads, hd).transpose(1, 2)
        v = linear(kv, self.value).reshape(b, -1, self.heads,
                                           hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / sqrt_in(hd, dt)
        attn = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v)
        return out.transpose(1, 2).reshape(b, n, c)


class _Attention(nn.Module):
    """HF ``attention``: ``self`` and ``output.dense``."""

    def __init__(self, dim: int, heads: int, sr_ratio: int):
        super().__init__()
        self.self = _SelfAttention(dim, heads, sr_ratio)
        self.output = nn.Module()
        self.output.dense = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        return linear(self.self(x, hw), self.output.dense)


class _MixFFN(nn.Module):
    """HF ``mlp``: ``dense1``, the depthwise ``dwconv.dwconv``,
    ``dense2``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, _ = x.shape
        y = linear(x, self.dense1)
        y = conv_nhwc(y.reshape(b, hw[0], hw[1], -1), self.dwconv.dwconv,
                      padding=1)
        y = F.gelu(y.reshape(b, n, -1), approximate="none")
        return linear(y, self.dense2)


class MiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, sr_ratio: int, mlp_ratio: int):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attention = _Attention(dim, heads, sr_ratio)
        self.layer_norm_2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = _MixFFN(dim, dim * mlp_ratio)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        x = x + self.attention(layer_norm(x, self.layer_norm_1), hw)
        return x + self.mlp(layer_norm(x, self.layer_norm_2), hw)


class MiTEncoder(nn.Module):
    """Four-stage Mix Transformer; returns the per-stage NHWC maps."""

    def __init__(self, config: MiTConfig, in_channels: int = 3):
        super().__init__()
        self.patch_embeddings = nn.ModuleList()
        self.block = nn.ModuleList()
        self.layer_norm = nn.ModuleList()
        cin = in_channels
        for s, width in enumerate(config.hidden_sizes):
            patch, stride = (7, 4) if s == 0 else (3, 2)
            embed = nn.Module()
            embed.proj = nn.Conv2d(cin, width, patch, stride=stride,
                                   padding=patch // 2)
            embed.layer_norm = nn.LayerNorm(width, eps=LN_EPS)
            self.patch_embeddings.append(embed)
            self.block.append(nn.ModuleList(
                MiTBlock(width, config.num_heads[s], config.sr_ratios[s],
                         config.mlp_ratio) for _ in range(config.depths[s])))
            self.layer_norm.append(nn.LayerNorm(width, eps=LN_EPS))
            cin = width

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats = []
        for embed, blocks, norm in zip(self.patch_embeddings, self.block,
                                       self.layer_norm):
            x = conv_nhwc(x, embed.proj, padding=embed.proj.padding[0])
            b, h, w, c = x.shape
            tokens = layer_norm(x.reshape(b, h * w, c), embed.layer_norm)
            for blk in blocks:
                tokens = blk(tokens, (h, w))
            x = layer_norm(tokens, norm).reshape(b, h, w, c)
            feats.append(x)
        return feats


class SegFormerHead(nn.Module):
    """All-MLP decode head -> (B, H/4, W/4, num_classes) logits."""

    def __init__(self, hidden_sizes, num_classes: int, decoder_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.linear_c = nn.ModuleList()
        for width in hidden_sizes:
            mlp = nn.Module()
            mlp.proj = nn.Linear(width, decoder_dim)
            self.linear_c.append(mlp)
        self.linear_fuse = nn.Conv2d(len(hidden_sizes) * decoder_dim,
                                     decoder_dim, 1, bias=False)
        self.batch_norm = nn.BatchNorm2d(decoder_dim)   # eps 1e-5, momentum 0.1
        self.dropout = SeededDropout(dropout)
        self.classifier = nn.Conv2d(decoder_dim, num_classes, 1)

    def forward(self, feats) -> torch.Tensor:
        size = tuple(feats[0].shape[1:3])
        proj = []
        for f, mlp in zip(feats, self.linear_c):
            y = linear(f, mlp.proj)
            if tuple(y.shape[1:3]) != size:
                y = resize_bilinear(y, size)
            proj.append(y)
        y = conv_nhwc(torch.cat(proj[::-1], dim=-1), self.linear_fuse,
                      padding=0)
        y = self.dropout(torch.relu(batch_norm(y, self.batch_norm)))
        return conv_nhwc(y, self.classifier, padding=0)


class SegFormer(nn.Module):
    """SegFormer with the reference's learned 4x tail. Protocol:
    ``requires_context = False``, ``returns_logits = True``. Input NHWC of
    any dtype (0-255 values), output NHWC f32 logits at the input's size;
    ``dtype`` is the compute dtype, parameters stay float32."""

    requires_context = False
    returns_logits = True

    def __init__(self, num_classes: int, config: MiTConfig = MIT_B3,
                 paper_normalization: bool = True, in_channels: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        del in_channels                     # the first three bands are read
        self.config, self.dtype = config, dtype
        self.paper_normalization = paper_normalization
        self.segformer = nn.Module()
        self.segformer.encoder = MiTEncoder(config)
        self.decode_head = SegFormerHead(config.hidden_sizes, num_classes,
                                         config.decoder_dim)
        self.seq = nn.ModuleList([
            nn.ConvTranspose2d(num_classes, num_classes, 8, stride=2,
                               padding=3), nn.ReLU(),
            nn.ConvTranspose2d(num_classes, num_classes, 4, stride=2,
                               padding=1), nn.ReLU(),
            nn.Conv2d(num_classes, num_classes, 3, padding=1)])
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.paper_normalization:
            x = x / 255.0
        x = ((x[..., :3] - self.mean) / self.std).to(self.dtype)
        logits = self.decode_head(self.segformer.encoder(x))
        y = torch.relu(conv_transpose_nhwc(logits, self.seq[0], padding=3))
        y = torch.relu(conv_transpose_nhwc(y, self.seq[2], padding=1))
        return conv_nhwc(y, self.seq[4], padding=1).float()
