"""Per-index patch access for inference (port of
``cvcs_tpu/data/inference_dataset.py``, the reference's ``GID15``
map-style dataset): ``ds[i]`` returns ``(patch, index_mask, context,
padded_patch)`` for global row-major patch index ``i``, read from a lazy
single-scene cache. The scene engine is the fast path; this view serves
per-patch tools, notebooks and spot checks.

As in the JAX package, and unlike the reference: the scene shape is
probed, not fixed at 6800 x 7200; ``random_shift=True`` works; the
border-correction window is centered unless ``bug_parity=True``. With
``load_context=True`` (off by default here, on by default in the JAX
package) ``context`` is the 3p window around the tile resized to p on the
CPU with the training path's math (``extract.resize_context_host``);
otherwise it is None.
"""

from __future__ import annotations

import numpy as np

from cvcs_tpu_torch.data import geometry
from cvcs_tpu_torch.data.extract import resize_context_host
from cvcs_tpu_torch.data.reader import SceneDataset


class InferenceDataset:
    """Map-style per-patch view over a GID15-style root."""

    def __init__(
        self,
        root: str,
        patch_size: int = 224,
        border_correction: int | None = None,
        load_context: bool = False,
        random_shift: bool = False,
        shift_offset: int = 20,
        bug_parity: bool = False,
        seed: int = 0,
    ):
        self.scenes = SceneDataset(root)
        self.patch_size = patch_size
        self.border_correction = border_correction
        self.load_context = load_context
        self.random_shift = random_shift
        self.shift_offset = shift_offset
        self.bug_parity = bug_parity
        self.rng = np.random.default_rng(seed)
        self.grid = geometry.TileGrid(self.scenes.image_shape, patch_size)
        self._cache_idx: int | None = None
        self._cache: tuple | None = None

    def __len__(self) -> int:
        return len(self.scenes) * self.grid.tiles_per_image

    def _scene(self, scene_idx: int):
        """The scene and its index mask, zero-padded so every window reads
        zeros out of bounds; the last one read is cached."""
        if self._cache_idx != scene_idx:
            p = self.patch_size
            # the margins add up: a shifted tile sits up to shift_offset
            # outside the grid, and its border window reaches past that
            pad = max(p, (self.border_correction or p) - p)
            if self.random_shift:
                pad += self.shift_offset
            img = np.pad(self.scenes.load_image(scene_idx),
                         ((pad, pad), (pad, pad), (0, 0)))
            msk = np.pad(self.scenes.load_index_mask(scene_idx),
                         ((pad, pad), (pad, pad)))
            self._cache_idx = scene_idx
            self._cache = (img, msk, pad)
        return self._cache

    def __getitem__(self, index: int):
        scene_idx, tile_idx = divmod(index, self.grid.tiles_per_image)
        img, msk, pad = self._scene(scene_idx)
        p = self.patch_size
        tly, tlx = self.grid.tile_origin(tile_idx)
        if self.random_shift:
            tly, tlx = geometry.random_shift(tly, tlx, self.shift_offset,
                                             self.rng)
        y, x = tly + pad, tlx + pad
        context = None
        if self.load_context:
            cy, cx, cs = geometry.context_window(y, x, p)
            context = resize_context_host(img[cy:cy + cs, cx:cx + cs], p)
        padded = None
        if self.border_correction:
            wy, wx, ws = geometry.border_window(
                y, x, p, self.border_correction,
                centered=not self.bug_parity)
            padded = img[wy:wy + ws, wx:wx + ws]
        return img[y:y + p, x:x + p], msk[y:y + p, x:x + p], context, padded
