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

On row strips (``core/mesh.py`` ``spatial_parallel``) the overlapping
patch embeddings, Mix-FFN's depthwise 3x3 and the tail take halos
(``models/blocks.py``), and the efficient attention keeps its queries on
the rank's tokens while it gathers the reduced K/V tokens of the whole
map (``halo.gather_rows``, differentiable): the ``sr`` conv runs on the
strip when the strip's rows are a multiple of ``sr``, and at ``sr`` 1
the tokens themselves are gathered. A stage whose strips cannot be
embedded locally (an odd strip before a stride-2 embedding) gathers its
input and runs whole (``whole_rows``); the head resizes each stage to
stage 1's rows following ``ops/resize.py`` (a whole stage resized whole,
then split) and its dropout keeps the rank's rows of the global mask.

The TP hook (JAX ``segformer.py:181-183``): under ``parallel/tp.py``
``tensor_parallel`` stage 4 is held channel-sharded; the sharded Q/K/V
projections hold whole heads, so the attention runs on the rank's heads,
and the residual sums and the head's concatenation gather the sharded
maps.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.models.blocks import (SeededDropout, batch_norm,
                                          conv_nhwc, conv_transpose_nhwc,
                                          layer_norm, linear, sqrt_in)
from cvcs_tpu_torch.ops.resize import resize_bilinear
from cvcs_tpu_torch.parallel import halo, tp

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

    def _kv(self, x: torch.Tensor, hw) -> torch.Tensor:
        """The K/V tokens of the whole map: on row strips, gathered."""
        b, _, c = x.shape
        sp = mesh_lib.strip_mesh()
        xm = x.reshape(b, hw[0], hw[1], c)
        sr = self.sr_ratio
        if sp is not None and sr > 1 and hw[0] % sr:
            xm = halo.gather_rows(xm, sp, f"segformer K/V reduction (sr {sr})"
                                  f" on {hw[0] * sp.shape['spatial']} rows",
                                  "strips not a multiple of sr")
            sp = None
        with mesh_lib.whole_rows(sp is None):
            if sr > 1:
                xm = conv_nhwc(xm, self.sr, padding=0)
                xm = layer_norm(xm, self.layer_norm)
        if sp is not None:
            xm = halo.gather_rows(xm, sp, f"segformer K/V (sr {sr}) of "
                                  f"{hw[0] * sp.shape['spatial']} rows",
                                  "K/V span the whole map (by design)")
        return xm.reshape(b, -1, c)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        dt = x.dtype
        q = linear(x, self.query)
        kv = self._kv(x, hw)
        hd = c // self.heads
        # -1 heads: under tensor parallelism the rank's heads
        q = q.reshape(b, n, -1, hd).transpose(1, 2)
        m = kv.shape[1]
        k = linear(kv, self.key).reshape(b, m, -1, hd).transpose(1, 2)
        v = linear(kv, self.value).reshape(b, m, -1, hd).transpose(1, 2)
        scores = torch.matmul(q, k.transpose(-1, -2)) / sqrt_in(hd, dt)
        attn = torch.softmax(scores.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v)
        return out.transpose(1, 2).reshape(b, n, -1)


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
        c = x.shape[-1]
        x = x + tp.full_channels(
            self.attention(layer_norm(x, self.layer_norm_1), hw), c)
        return x + tp.full_channels(
            self.mlp(layer_norm(x, self.layer_norm_2), hw), c)


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

    def forward(self, x: torch.Tensor,
                wholes: list | None = None) -> list[torch.Tensor]:
        """Each stage's NHWC map; ``wholes``, when given, receives for each
        whether its map is whole on every rank (False off row strips, and
        for a stage held in strips)."""
        sp = mesh_lib.strip_mesh()
        whole = False
        feats = []
        for s, (embed, blocks, norm) in enumerate(zip(
                self.patch_embeddings, self.block, self.layer_norm)):
            stride = embed.proj.stride[0]
            if sp is not None and not whole and x.shape[1] % stride:
                x = halo.gather_rows(x, sp, f"segformer stage {s + 1} "
                                     "patch embedding", "odd strips")
                whole = True
            with mesh_lib.whole_rows(whole):
                x = conv_nhwc(x, embed.proj, padding=embed.proj.padding[0])
                b, h, w, _ = x.shape
                tokens = layer_norm(x.reshape(b, h * w, -1), embed.layer_norm)
                for blk in blocks:
                    tokens = blk(tokens, (h, w))
                x = layer_norm(tokens, norm).reshape(b, h, w, -1)
            if s == 3:
                x = tp.constrain(x, self.layer_norm[s].normalized_shape[0])
            feats.append(x)
            if wholes is not None:
                wholes.append(whole)
        return feats


class SegFormerHead(nn.Module):
    """All-MLP decode head -> (B, H/4, W/4, num_classes) logits."""

    def __init__(self, hidden_sizes, num_classes: int, decoder_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.decoder_dim = decoder_dim
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
        """``feats``: the encoder's maps, or (map, whole) pairs on row
        strips."""
        feats = [f if isinstance(f, tuple) else (f, False) for f in feats]
        size = tuple(feats[0][0].shape[1:3])
        sp = mesh_lib.strip_mesh()
        proj = []
        for (f, whole), mlp in zip(feats, self.linear_c):
            y = linear(f, mlp.proj)
            if whole:
                n = sp.shape[mesh_lib.SPATIAL_AXIS]
                with mesh_lib.whole_rows():
                    y = resize_bilinear(y, (size[0] * n, size[1]))
                y = halo.split_rows(y, sp)
            elif tuple(y.shape[1:3]) != size:
                y = resize_bilinear(y, size)
            proj.append(tp.full_channels(y, self.decoder_dim))
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
        wholes = []
        feats = self.segformer.encoder(x, wholes)
        logits = self.decode_head(list(zip(feats, wholes)))
        y = torch.relu(conv_transpose_nhwc(logits, self.seq[0], padding=3))
        y = torch.relu(conv_transpose_nhwc(y, self.seq[2], padding=1))
        return conv_nhwc(y, self.seq[4], padding=1).float()
