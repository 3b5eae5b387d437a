"""Resize and upsample on NHWC tensors (port of ``cvcs_tpu/ops/resize.py``).

``jax.image.resize``'s bilinear method uses half-pixel centres and, when it
shrinks a map, a triangle filter widened by the scale (antialiasing);
``F.interpolate(mode="bilinear", align_corners=False, antialias=True)``
computes the same. Bilinear resizes run in f32 (f64 for an f64 input)
and cast back to the input's dtype, as the JAX functions do.
``resize_nearest`` is ``jax.image.resize``'s nearest method
(``F.interpolate``'s ``"nearest-exact"`` rule), written as a gather so
that integer label maps keep their dtype.

On row strips (``core/mesh.py`` ``spatial_parallel``) ``size`` is the
strip's. An upsample by a whole factor f reads, for the strip's output
rows, one source row beyond each edge of the strip: the rank takes a
one-row halo, repeats its edge row where the strip meets the global
map's border (the clamp of the whole map's resize), resizes the
extended strip with the same scale and keeps the f x h rows of its own.
Any other ratio gathers the map, resizes it whole and splits it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.parallel import halo


def resize_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize to an explicit (H, W) (on row strips, the
    strip's rows of the whole map's resize)."""
    sp = mesh_lib.strip_mesh()
    if sp is not None:
        return _strip_resize(x, size, sp)
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


def _strip_resize(x: torch.Tensor, size, sp) -> torch.Tensor:
    n, s = sp.shape[mesh_lib.SPATIAL_AXIS], sp.spatial_index
    h, out_h = x.shape[1], size[0]
    if out_h % h:
        whole = halo.gather_rows(x, sp, f"resize of {h * n} rows to "
                                 f"{out_h * n}", "not a whole upsample")
        with mesh_lib.whole_rows():
            y = resize_bilinear(whole, (out_h * n, size[1]))
        return halo.split_rows(y, sp)
    f = out_h // h
    ext = halo.row_halo(x, sp, 1, 1)
    # the global borders repeat their edge row, as the whole map's clamp
    if s == 0:
        ext = torch.cat([x[:, :1], ext[:, 1:]], dim=1)
    if s == n - 1:
        ext = torch.cat([ext[:, :-1], x[:, -1:]], dim=1)
    with mesh_lib.whole_rows():
        y = resize_bilinear(ext, ((h + 2) * f, size[1]))
    return y[:, f:f + out_h]
