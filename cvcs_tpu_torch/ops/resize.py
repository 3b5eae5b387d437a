"""Resize and upsample on NHWC tensors (port of ``cvcs_tpu/ops/resize.py``).

``jax.image.resize``'s bilinear method uses half-pixel centres and, when it
shrinks a map, a triangle filter widened by the scale (antialiasing);
``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
computes the same. Bilinear resizes run in f32 (f64 for an f64 input)
and cast back to the input's dtype, as the JAX functions do.
``resize_nearest`` is ``jax.image.resize``'s nearest method
(``F.interpolate``'s ``"nearest-exact"`` rule), written as a gather so
that integer label maps keep their dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize to an explicit (H, W)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    y = F.interpolate(x.permute(0, 3, 1, 2).to(wide), size=tuple(size),
                      mode="bilinear", align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """NHWC bilinear upsample by an integer factor (align_corners=False)."""
    return resize_bilinear(x, (x.shape[1] * scale, x.shape[2] * scale))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of (B, H, W, ...) — label masks keep their
    dtype (``F.interpolate`` itself takes no integer maps)."""
    b, h, w = x.shape[:3]
    rows = _nearest_index(h, size[0], x.device)
    cols = _nearest_index(w, size[1], x.device)
    return x[:, rows[:, None], cols[None, :]]


def _nearest_index(n_in: int, n_out: int, device) -> torch.Tensor:
    """Source index of each output pixel under half-pixel centres:
    floor((i + 0.5) * n_in / n_out), clamped to the map."""
    i = torch.arange(n_out, device=device, dtype=torch.float64)
    src = torch.floor((i + 0.5) * (n_in / n_out)).to(torch.int64)
    return src.clamp_(0, n_in - 1)
