"""Patch extraction from zero-padded scene stacks on the device (port of
``cvcs_tpu/data/extract.py``). Scenes are padded once so that windows
reaching outside a scene read zeros.

Context windows (3p x 3p around a tile) and ``random_tps`` crops are
resized to p x p with ``ops/resize.py``: imagery by the antialiased
bilinear resize of ``jax.image.resize`` (torchvision's ``Resize``
default), computed in f32, rounded half to even and clipped to 0..255 as
the JAX package does; label masks by the half-pixel nearest rule
(torchvision's ``NEAREST_EXACT``). The two frameworks' f32 filters sum in
different orders, so a pixel whose value lands next to a .5 may round
the other way: images agree within one level, masks exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from cvcs_tpu_torch.ops.resize import resize_bilinear, resize_nearest


def pad_scenes(images: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad a (N, H, W, ...) scene stack by ``pad`` on both spatial
    dims."""
    cfg = [(0, 0), (pad, pad), (pad, pad)] + [(0, 0)] * (images.ndim - 3)
    return np.pad(images, cfg)


def slice_windows(scenes: torch.Tensor, coords: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Gather (B, size, size, ...) windows from (N, Hp, Wp, ...) scenes.
    ``coords`` (B, 3) holds (scene, top, left) in padded coordinates; a
    start that would put the window outside the scene is clamped, as
    XLA's ``dynamic_slice`` clamps it (the loaders pad so that none is,
    save a ``random_tps`` crop smaller than the patch, whose context
    window would reach past the padding)."""
    coords = coords.to(device=scenes.device, dtype=torch.int64)
    ar = torch.arange(size, device=scenes.device)
    top = coords[:, 1:2].clamp(0, scenes.shape[1] - size)
    left = coords[:, 2:3].clamp(0, scenes.shape[2] - size)
    rows = (top + ar).unsqueeze(2)                       # (B, size, 1)
    cols = (left + ar).unsqueeze(1)                      # (B, 1, size)
    return scenes[coords[:, 0].view(-1, 1, 1), rows, cols]


def _to_uint8(x: torch.Tensor, dtype) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(dtype)


def extract_context(scenes: torch.Tensor, coords: torch.Tensor,
                    patch_size: int) -> torch.Tensor:
    """The 3p x 3p context window of each tile, resized to p x p.
    ``coords`` (B, 3) are the tiles' (scene, top, left) in padded
    coordinates; the window starts one patch up and left of the tile."""
    p = patch_size
    shift = torch.tensor([0, p, p], dtype=coords.dtype, device=coords.device)
    big = slice_windows(scenes, coords - shift, 3 * p)
    return _to_uint8(resize_bilinear(big.to(torch.float32), (p, p)),
                     scenes.dtype)


def resize_context_host(big: np.ndarray, patch_size: int) -> np.ndarray:
    """One (3p, 3p, C) context window -> (p, p, C) on the CPU, with the
    training path's math (:func:`extract_context`'s resize)."""
    t = torch.from_numpy(np.ascontiguousarray(big, np.float32))[None]
    out = _to_uint8(resize_bilinear(t, (patch_size, patch_size)),
                    torch.float32)
    return out[0].numpy().astype(big.dtype)


def extract_resized(images: torch.Tensor, masks: torch.Tensor,
                    coords: torch.Tensor, crop_size: int, patch_size: int):
    """``random_tps`` crops: a ``crop_size`` window at each of ``coords``
    resized to ``patch_size``, bilinear for the image and nearest for the
    label mask."""
    p = patch_size
    img = slice_windows(images, coords, crop_size).to(torch.float32)
    msk = slice_windows(masks, coords, crop_size)
    return (_to_uint8(resize_bilinear(img, (p, p)), images.dtype),
            resize_nearest(msk, (p, p)))
