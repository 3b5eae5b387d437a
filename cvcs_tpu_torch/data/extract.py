"""Patch extraction from zero-padded scene stacks on the device (port of
``cvcs_tpu/data/extract.py``). Scenes are padded once so that windows
reaching outside a scene read zeros."""

from __future__ import annotations

import numpy as np
import torch


def pad_scenes(images: np.ndarray, pad: int) -> np.ndarray:
    """Zero-pad a (N, H, W, ...) scene stack by ``pad`` on both spatial
    dims."""
    cfg = [(0, 0), (pad, pad), (pad, pad)] + [(0, 0)] * (images.ndim - 3)
    return np.pad(images, cfg)


def slice_windows(scenes: torch.Tensor, coords: torch.Tensor,
                  size: int) -> torch.Tensor:
    """Gather (B, size, size, ...) windows from (N, Hp, Wp, ...) scenes.
    ``coords`` (B, 3) holds (scene, top, left) in padded coordinates,
    which the caller keeps in range."""
    coords = coords.to(device=scenes.device, dtype=torch.int64)
    ar = torch.arange(size, device=scenes.device)
    rows = (coords[:, 1:2] + ar).unsqueeze(2)            # (B, size, 1)
    cols = (coords[:, 2:3] + ar).unsqueeze(1)            # (B, 1, size)
    return scenes[coords[:, 0].view(-1, 1, 1), rows, cols]


def extract_context(*_args, **_kwargs):
    raise NotImplementedError(
        "context windows (load_context) are not yet ported to "
        "cvcs_tpu_torch; see ROADMAP.md Queue 1 item 4 (data)")


def extract_resized(*_args, **_kwargs):
    raise NotImplementedError(
        "random_tps multi-scale crops are not yet ported to cvcs_tpu_torch; "
        "see ROADMAP.md Queue 1 item 4 (data)")
