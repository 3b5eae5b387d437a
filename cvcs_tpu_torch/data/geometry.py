"""Tile-grid geometry (port of ``cvcs_tpu/data/geometry.py``): row-major
tiling of an H x W scene into p x p tiles, the context and
border-correction windows, the training loader's random shift, and the
chunk partition of a scene list. Out-of-range coordinates are legal:
crops are taken from zero-padded scenes."""

from __future__ import annotations

import dataclasses

import numpy as np

#: Patch sizes the reference "supports or recommends".
REFERENCE_PATCH_SIZES = (224, 256, 512)


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

    def tile_origin(self, tile_idx):
        """(tly, tlx) of row-major ``tile_idx``."""
        return ((tile_idx // self.cols) * self.patch_size,
                (tile_idx % self.cols) * self.patch_size)

    def origins(self) -> np.ndarray:
        """All tile origins, (tiles_per_image, 2), row-major."""
        tly, tlx = self.tile_origin(np.arange(self.tiles_per_image))
        return np.stack([tly, tlx], axis=-1)


def context_window(tly, tlx, patch_size: int):
    """Top-left and size of the 3p x 3p context window."""
    return tly - patch_size, tlx - patch_size, 3 * patch_size


def border_window(tly, tlx, patch_size: int, border_correction: int,
                  centered: bool = True):
    """Top-left and size of the bc x bc border-corrected window: the patch
    at its centre, or (``centered=False``) at its bottom right, as the
    reference anchors it."""
    margin = border_correction - patch_size
    off = margin // 2 if centered else margin
    return tly - off, tlx - off, border_correction


def random_shift(tly, tlx, offset: int, rng: np.random.Generator):
    """Uniform +-offset jitter of a tile origin."""
    return (tly + rng.integers(-offset, offset + 1),
            tlx + rng.integers(-offset, offset + 1))


def chunk_partition(indices: list[int], chunk_size: int) -> list[list[int]]:
    """Consecutive fixed-size chunks of scene indices; the count must
    divide, as the reference asserts."""
    if len(indices) % chunk_size != 0:
        raise ValueError(
            f"number of scenes ({len(indices)}) not divisible by chunk size "
            f"({chunk_size})")
    return [list(indices[off * chunk_size:(off + 1) * chunk_size])
            for off in range(len(indices) // chunk_size)]
