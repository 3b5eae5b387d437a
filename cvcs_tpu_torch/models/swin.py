"""Swin-UNet: shifted-window transformer encoder + UNet decoder (port of
``cvcs_tpu/models/swin.py``).

Public layout follows the JAX model: input NHWC ``(B, H, W, bands)`` of
any dtype, output NHWC float32 logits. Activations stay NHWC in the
compute dtype (bf16 by default, f32 under ``precision: f32``); parameters
are float32. State-dict names are those of the torch twin
``cvcs_tpu/utils/torch_swin_ref.py`` (``patch_embed.*``,
``layers.{s}.blocks.{d}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``layers.{s}.downsample.*``, ``decoder.{i}.*``, ``head.*``), so what
``cvcs_tpu.utils.torch_export.export_swin`` writes loads here with
``strict=True``.

Every block whose window is at least 4 runs the pre-MLP half (LN, QKV,
masked window attention, output projection) through the fused op
:func:`cvcs_tpu_torch.ops.swin_attn.swin_window_attention` — on the card
the forward kernel, and under autograd the backward kernel too. Clamped
windows below 4 (maps of 1-3 tokens a side) take the einsum path, as in
the JAX model. Under ``train()`` the decoder's BatchNorm runs on batch
statistics and updates the running ones.

On row strips (``core/mesh.py`` ``spatial_parallel``) each rank computes
the windows that hold any of its rows. The shifted block's cyclic roll
of rows becomes a ring halo (``parallel/halo.py`` ``row_halo`` with
``ring``): the rows above rank 0's first window come from the last
rank's bottom, and the rows below the last rank's from rank 0's top;
columns roll locally. A window that straddles two strips is computed by
both ranks from the halo; each keeps its own rows, and the halo's
backward sums the gradients of the rest. The last rank holds the
window pad rows. The (nWin, T, T) mask is the whole map's, indexed by
the rank's window rows. Only when a halo would be wider than a
neighbour's strip does a block gather the map. A stage whose strips have
an odd number of rows gathers before its 2x2 downsample and runs whole
(``whole_rows``), and the decoder splits the map again where it meets a
skip held in strips. K1 and K2 run on each rank's windows either way.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.models.blocks import (DecodeBlock, conv_nhwc,
                                          conv_transpose_nhwc, layer_norm,
                                          linear)
from cvcs_tpu_torch.parallel import halo
from cvcs_tpu_torch.ops.swin_attn import (swin_window_attention,
                                          window_merge, window_partition)


def _shift_mask(h: int, w: int, win: int, shift: int) -> np.ndarray:
    """Region-id attention mask for shifted windows, (nWin, T, T) bool
    (True = may attend). The three bands per axis describe the ROLLED map
    directly, so the id grid is not rolled again."""
    ids = np.zeros((h, w), np.int32)
    h_bands = (slice(0, h - win), slice(h - win, h - shift),
               slice(h - shift, h))
    w_bands = (slice(0, w - win), slice(w - win, w - shift),
               slice(w - shift, w))
    cnt = 0
    for hb in h_bands:
        for wb in w_bands:
            ids[hb, wb] = cnt
            cnt += 1
    ids = ids.reshape(h // win, win, w // win, win)
    ids = ids.transpose(0, 2, 1, 3).reshape(-1, win * win)
    return ids[:, :, None] == ids[:, None, :]


def _attn_mask(h: int, w: int, h0: int, w0: int, win: int,
               shift: int) -> np.ndarray | None:
    """Combined shifted-region x pad-validity mask, (nWin, T, T) bool, or
    None when nothing needs masking. Pad tokens are excluded as keys; the
    validity grid follows the features' roll (unlike the band ids)."""
    region = _shift_mask(h, w, win, shift) if shift else None
    if h == h0 and w == w0:
        return region
    valid = np.zeros((h, w), bool)
    valid[:h0, :w0] = True
    if shift:
        valid = np.roll(valid, (-shift, -shift), axis=(0, 1))
    v = valid.reshape(h // win, win, w // win, win)
    v = v.transpose(0, 2, 1, 3).reshape(-1, win * win)
    keys_ok = np.broadcast_to(v[:, None, :], (v.shape[0],) + (v.shape[1],) * 2)
    return keys_ok if region is None else (region & keys_ok)


@functools.lru_cache(maxsize=None)
def attn_bias(h: int, w: int, h0: int, w0: int, win: int, shift: int,
              device: torch.device) -> torch.Tensor | None:
    """The mask as the fused op's additive f32 bias (0 / -1e9), built once
    per geometry and kept on ``device``."""
    mask = _attn_mask(h, w, h0, w0, win, shift)
    if mask is None:
        return None
    return torch.from_numpy(
        np.where(mask, 0.0, -1e9).astype(np.float32)).to(device)


class WindowAttention(nn.Module):
    """QKV and output projections (``attn.qkv``, ``attn.proj``)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def einsum(self, tokens: torch.Tensor, bias) -> torch.Tensor:
        """The JAX einsum path (``WindowAttention.__call__``) on LN'd
        tokens (nB, T, C): QKV and scores in the compute dtype, f32
        softmax with masked scores replaced by -1e9."""
        dt = tokens.dtype
        nb, t, c = tokens.shape
        hd = c // self.heads
        q, k, v = linear(tokens, self.qkv).reshape(
            nb, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-1, -2)) / torch.tensor(math.sqrt(hd), dtype=dt)
        attn = attn.float()
        if bias is not None:
            n_win = bias.shape[0]
            attn = attn.reshape(nb // n_win, n_win, self.heads, t, t)
            attn = torch.where(bias[None, :, None] == 0, attn,
                               torch.tensor(-1e9, device=attn.device))
            attn = attn.reshape(nb, self.heads, t, t)
        attn = torch.softmax(attn, dim=-1).to(dt)
        out = (attn @ v).permute(0, 2, 1, 3).reshape(nb, t, c)
        return linear(out, self.proj)


class Mlp(nn.Module):
    def __init__(self, dim: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shifted: bool,
                 mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.window = window
        self.shifted = shifted
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio)

    def _geometry(self, h0: int, w0: int) -> tuple[int, int]:
        """(window, shift) of a map of h0 x w0 tokens."""
        win = min(self.window, h0, w0)
        # a map that is a single window is not shifted (official Swin)
        shift = (win // 2 if (self.shifted and win > 1
                              and min(h0, w0) > win) else 0)
        return win, shift

    def _windows(self, y, bias, win: int, shift: int) -> torch.Tensor:
        """The pre-residual attention of a padded map ``y`` whose rows
        start on a window row (already rolled by the shift there), with
        the mask ``bias`` of its windows; its columns are rolled here by
        ``shift`` and back."""
        _, h, w, _ = y.shape
        if win >= 4:
            # LN is position-wise, so the op sees the rolled raw map
            if shift:
                y = torch.roll(y, -shift, dims=2)
            a = self.attn
            y = swin_window_attention(
                y, self.norm1.weight, self.norm1.bias, a.qkv.weight.t(),
                a.qkv.bias, a.proj.weight.t(), a.proj.bias, bias,
                win=win, heads=self.heads)
        else:
            y = layer_norm(y, self.norm1)
            if shift:
                y = torch.roll(y, -shift, dims=2)
            y = window_merge(self.attn.einsum(window_partition(y, win), bias),
                             win, h, w)
        return torch.roll(y, shift, dims=2) if shift else y

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        """Pad, roll, window attention, roll back, unpad: a whole map."""
        _, h0, w0, _ = x.shape
        win, shift = self._geometry(h0, w0)
        ph, pw = -h0 % win, -w0 % win
        x_pad = F.pad(x, (0, 0, 0, pw, 0, ph)) if (ph or pw) else x
        h, w = h0 + ph, w0 + pw
        bias = attn_bias(h, w, h0, w0, win, shift, x.device)
        y = (torch.roll(x_pad, (-shift, -shift), dims=(1, 2)) if shift
             else x_pad)
        y = self._windows(y, bias, win, 0)
        if shift:
            y = torch.roll(y, (shift, shift), dims=(1, 2))
        # the pad is sliced off before the residual and the MLP
        return y[:, :h0, :w0]

    def _attend_strip(self, x: torch.Tensor, sp) -> torch.Tensor:
        """:meth:`_attend`'s rows of this rank's strip. The rolled map's
        window rows that hold the strip's rows are, in the unrolled map,
        a cyclic run of rows from ``tops[s]`` above the strip to
        ``bots[s]`` below it: a ring halo brings them, already in the
        rolled order."""
        n, s = sp.shape[mesh_lib.SPATIAL_AXIS], sp.spatial_index
        _, h, w0, _ = x.shape
        h0 = h * n
        win, shift = self._geometry(h0, w0)
        ph, pw = -h0 % win, -w0 % win
        hp, wp = h0 + ph, w0 + pw
        rows = [h] * (n - 1) + [h + ph]          # the last rank holds the pad
        starts = [j * h for j in range(n)]
        tops = [(r0 - shift) % win for r0 in starts]
        bots = [(shift - r0 - r) % win for r0, r in zip(starts, rows)]
        if not halo.halo_fits(rows, tops, bots, ring=True):
            whole = halo.gather_rows(
                x, sp, f"swin window attention on {h0} x {w0} tokens, "
                f"window {win}", "windows reach past a neighbour's strip")
            with mesh_lib.whole_rows():
                y = self._attend(whole)
            return halo.split_rows(y, sp)
        pad_rows = ph if s == n - 1 else 0
        x_pad = (F.pad(x, (0, 0, 0, pw, 0, pad_rows)) if (pw or pad_rows)
                 else x)
        ext = halo.row_halo(x_pad, sp, tops, bots, ring=True)
        bias = attn_bias(hp, wp, h0, w0, win, shift, x.device)
        if bias is not None:
            first = (starts[s] - tops[s] - shift) % hp // win
            idx = [(first + i) % (hp // win) for i in range(ext.shape[1] // win)]
            t = win * win
            bias = bias.view(hp // win, wp // win, t, t)[idx].reshape(-1, t, t)
        y = self._windows(ext, bias, win, shift)
        return y[:, tops[s]:tops[s] + h, :w0]

    def forward(self, x: torch.Tensor) -> torch.Tensor:   # (B, H, W, C)
        sp = mesh_lib.strip_mesh()
        y = self._attend(x) if sp is None else self._attend_strip(x, sp)
        x = x + y
        return x + self.mlp(layer_norm(x, self.norm2))


class _Downsample(nn.Module):
    """Patch merging as a 2x2/2 conv without bias, then LN."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, 2, stride=2, bias=False)
        self.norm = nn.LayerNorm(cout, eps=1e-6)

    def forward(self, x):
        return layer_norm(conv_nhwc(x, self.proj), self.norm)


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, depth: int, heads: int,
                 window: int, downsample: bool):
        super().__init__()
        self.downsample = _Downsample(cin, cout) if downsample else None
        self.blocks = nn.ModuleList(
            [SwinBlock(cout, heads, window, shifted=bool(i % 2))
             for i in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            x = self.downsample(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class _Decode(DecodeBlock):
    """ConvTranspose k=s=2 up, concat [skip, up], DecodeBlock."""

    def __init__(self, cin: int, cout: int):
        super().__init__(2 * cout, cout)
        self.up = nn.ConvTranspose2d(cin, cout, 2, stride=2)

    def forward(self, y, skip):
        return self.decode(torch.cat([skip, conv_transpose_nhwc(y, self.up)],
                                     dim=-1))


class _Head(nn.Module):
    """4x back to input resolution: 2 x (ConvTranspose + ReLU), conv3x3."""

    def __init__(self, cin: int, num_classes: int):
        super().__init__()
        self.up1 = nn.ConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.up2 = nn.ConvTranspose2d(cin // 2, cin // 2, 2, stride=2)
        self.out = nn.Conv2d(cin // 2, num_classes, 3, padding=1)

    def forward(self, y):
        y = torch.relu(conv_transpose_nhwc(y, self.up1))
        y = torch.relu(conv_transpose_nhwc(y, self.up2))
        return conv_nhwc(y, self.out, padding=1)


class SwinUNet(nn.Module):
    """Swin-T encoder (depths 2/2/6/2) + UNet decoder, any band count.

    Protocol: ``requires_context = False``, ``returns_logits = True``.
    ``dtype`` is the compute dtype; parameters stay float32."""

    requires_context = False
    returns_logits = True

    def __init__(self, num_classes: int, dims=(96, 192, 384, 768),
                 depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window: int = 8,
                 in_channels: int = 3, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.depths = tuple(depths)
        self.dtype = dtype
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(in_channels, dims[0], 4, stride=4)
        self.patch_embed.norm = nn.LayerNorm(dims[0], eps=1e-6)
        self.layers = nn.ModuleList(
            [_Stage(dims[max(s - 1, 0)], dims[s], depths[s], heads[s],
                    window, downsample=(s > 0)) for s in range(4)])
        self.decoder = nn.ModuleList(
            [_Decode(dims[s + 1], dims[s]) for s in (2, 1, 0)])
        self.head = _Head(dims[0], num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        x = layer_norm(conv_nhwc(x, self.patch_embed.proj),
                       self.patch_embed.norm)
        sp = mesh_lib.strip_mesh()
        whole = False
        skips = []
        for i, stage in enumerate(self.layers):
            if (stage.downsample is not None and sp is not None
                    and not whole and x.shape[1] % 2):
                x = halo.gather_rows(x, sp, f"swin stage {i + 1} downsample",
                                     "odd strips")
                whole = True
            with mesh_lib.whole_rows(whole):
                x = stage(x)
            skips.append((x, whole))
        y, whole = skips[-1]
        for dec, s in zip(self.decoder, (2, 1, 0)):
            skip, skip_whole = skips[s]
            with mesh_lib.whole_rows(whole):
                y = conv_transpose_nhwc(y, dec.up)
            if whole and not skip_whole:
                y, whole = halo.split_rows(y, sp), False
            with mesh_lib.whole_rows(whole):
                y = dec.decode(torch.cat([skip, y], dim=-1))
        with mesh_lib.whole_rows(whole):
            y = self.head(y)
        if whole and sp is not None:
            y = halo.split_rows(y, sp)
        return y.float()
