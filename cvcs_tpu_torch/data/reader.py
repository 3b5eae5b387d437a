"""Host-side scene raster reader (port of ``cvcs_tpu/data/reader.py``),
decoding with PIL, and the class statistics of a dataset's index masks.

GID15 directory layout:

    <root>/Image__8bit_NirRGB/<stem>.<ext>          full scenes
    <root>/Annotation__index/<stem>_15label.png     per-pixel class labels
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image

IMAGE_DIR = "Image__8bit_NirRGB"
INDEX_DIR = "Annotation__index"
MASK_SUFFIX = "_15label"
RASTER_SUFFIXES = {".png", ".jpg", ".jpeg", ".tif", ".tiff"}


class SceneDataset:
    """Lists and decodes the scenes of a GID15-style dataset root."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.image_dir = self.root / IMAGE_DIR
        self.index_dir = self.root / INDEX_DIR
        if not self.image_dir.is_dir():
            raise FileNotFoundError(f"no {IMAGE_DIR} under {self.root}")
        # raster files only: a stray file would shift scene<->mask pairing
        self.image_paths = sorted(
            p for p in self.image_dir.iterdir()
            if p.is_file() and p.suffix.lower() in RASTER_SUFFIXES)
        if not self.image_paths:
            raise FileNotFoundError(f"no scenes under {self.image_dir}")
        self._shape: tuple[int, int] | None = None
        self._class_counts: dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.image_paths)

    def _mask_path(self, directory: Path, i: int, preferred: str) -> Path:
        """``<stem>_15label.<ext>``, preferring ``preferred`` and tolerating
        the other raster extensions."""
        stem = self.image_paths[i].stem + MASK_SUFFIX
        first = directory / (stem + preferred)
        if first.exists():
            return first
        for ext in sorted(RASTER_SUFFIXES - {preferred}):
            p = directory / (stem + ext)
            if p.exists():
                return p
        return first  # let the decode raise with the canonical name

    def index_mask_path(self, i: int) -> Path:
        return self._mask_path(self.index_dir, i, ".png")

    @property
    def image_shape(self) -> tuple[int, int]:
        """(H, W) of the first scene, from its header."""
        if self._shape is None:
            with Image.open(self.image_paths[0]) as im:
                self._shape = (im.height, im.width)
        return self._shape

    @staticmethod
    def _decode(path) -> np.ndarray:
        Image.MAX_IMAGE_PIXELS = None   # GID15 scenes are 49 Mpx
        with Image.open(path) as im:
            return np.asarray(im)

    def load_image(self, i: int) -> np.ndarray:
        """Scene image as (H, W, C) uint8."""
        arr = self._decode(self.image_paths[i])
        return arr[..., None] if arr.ndim == 2 else arr

    def load_index_mask(self, i: int) -> np.ndarray:
        """Index mask as (H, W) uint8; 3-channel masks collapse to
        channel 0."""
        arr = self._decode(self.index_mask_path(i))
        return arr[..., 0] if arr.ndim == 3 else arr

    def class_counts(self, num_classes: int) -> np.ndarray:
        """Per-class pixel counts over all index masks, cached per
        instance."""
        if num_classes not in self._class_counts:
            counts = np.zeros(num_classes, dtype=np.int64)
            for i in range(len(self)):
                mask = self.load_index_mask(i)
                counts += np.bincount(mask.reshape(-1),
                                      minlength=num_classes)[:num_classes]
            self._class_counts[num_classes] = counts
        return self._class_counts[num_classes]


def class_weights(counts: np.ndarray,
                  ignore_background: bool = False) -> np.ndarray:
    """Class-balanced weights w_j = total / (bins * count_j); zero-count
    classes get 0; with ``ignore_background`` class 0 is left out of the
    statistics and weighted 0."""
    counts = np.asarray(counts, dtype=np.float64)
    active = counts[1:] if ignore_background else counts
    total = active.sum()
    bins = len(active)
    w = np.where(active > 0, total / (bins * np.maximum(active, 1)), 0.0)
    if ignore_background:
        w = np.concatenate([[0.0], w])
    return w.astype(np.float32)


def class_priors(counts: np.ndarray) -> np.ndarray:
    """total / count_j."""
    counts = np.asarray(counts, dtype=np.float64)
    return (counts.sum() / counts).astype(np.float32)
