"""Tile-grid geometry (port of ``TileGrid`` in ``cvcs_tpu/data/geometry.py``):
row-major tiling of an H x W scene into p x p tiles."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TileGrid:
    image_shape: tuple[int, int]  # (H, W)
    patch_size: int

    @property
    def rows(self) -> int:
        return self.image_shape[0] // self.patch_size

    @property
    def cols(self) -> int:
        return self.image_shape[1] // self.patch_size

    @property
    def tiles_per_image(self) -> int:
        return self.rows * self.cols

