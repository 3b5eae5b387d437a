"""Chunked training/eval data loading (port of ``cvcs_tpu/data/loader.py``).

The host decodes a chunk's scenes once (PIL -> numpy uint8), pads them and
ships them to the device; every crop and augmentation happens there. A
chunk holds all its patches as contiguous uint8 device tensors and serves
fixed-shape batches as slices.

Randomness follows the JAX loader draw for draw: one
``np.random.default_rng(seed)`` drives the per-epoch scene shuffle, the
+-20 px tile shifts and the per-chunk patch permutation, in the same
order, so for one seed the chunks equal the JAX loader's. Augmentation
draws come from a ``torch.Generator`` on the device (seeded
``seed ^ 0x5EED``); they differ from ``jax.random``'s.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from cvcs_tpu_torch.core.device import resolve_device
from cvcs_tpu_torch.data import extract, geometry, reader
from cvcs_tpu_torch.data.augment import AugmentConfig, augment_chunk

SHIFT_OFFSET = 20  # the reference's +-20 px tile jitter


@dataclasses.dataclass
class Batch:
    """One micro-batch on the device, NHWC uint8 imagery."""

    image: torch.Tensor                 # (B, p, p, C) uint8
    mask: torch.Tensor                  # (B, p, p) int32
    valid: torch.Tensor | None = None   # (B,) bool, False for padding


class DeviceChunk:
    """A chunk's patches on the device."""

    def __init__(self, images: torch.Tensor, masks: torch.Tensor):
        self.images = images
        self.masks = masks

    def __len__(self) -> int:
        return int(self.images.shape[0])

    def batches(self, batch_size: int, drop_last: bool = True,
                pad_tail: bool = True) -> Iterator[Batch]:
        """Fixed-shape batches. With ``drop_last=False`` the final partial
        batch is padded by repeating sample 0 and flagged in ``valid``,
        or, with ``pad_tail=False``, yielded at its natural size."""
        n = len(self)
        full = n // batch_size
        for b in range(full):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            yield Batch(self.images[sl], self.masks[sl])
        rem = n - full * batch_size
        if rem and not drop_last:
            if pad_tail:
                yield self._tail_batch(batch_size, full, rem)
            else:
                sl = slice(full * batch_size, n)
                yield Batch(self.images[sl], self.masks[sl])

    def _tail_batch(self, batch_size: int, full: int, rem: int) -> Batch:
        n = len(self)
        dev = self.images.device
        idx = torch.cat([torch.arange(full * batch_size, n, device=dev),
                         torch.zeros(batch_size - rem, dtype=torch.int64,
                                     device=dev)])
        return Batch(self.images[idx], self.masks[idx],
                     valid=torch.arange(batch_size, device=dev) < rem)


class ChunkLoader:
    """Drives chunked loading of a GID15-style dataset root. Context
    windows (``load_context``) and ``random_tps`` crops raise
    ``NotImplementedError``."""

    def __init__(self, root: str, chunk_size: int = 2, patch_size: int = 224,
                 random_shift: bool = False,
                 augment: AugmentConfig | None = None,
                 load_context: bool = False, in_channels: int = 3,
                 seed: int = 0, device=None):
        if load_context:
            extract.extract_context()
        self.device = resolve_device(device)
        self.dataset = reader.SceneDataset(root)
        self.patch_size = patch_size
        self.chunk_size = chunk_size
        self.random_shift = random_shift
        self.augment = augment
        self.in_channels = in_channels
        self.rng = np.random.default_rng(seed)
        self.aug_gen = torch.Generator(device=self.device).manual_seed(
            seed ^ 0x5EED)
        self.image_shape = self.dataset.image_shape
        self.grid = geometry.TileGrid(self.image_shape, patch_size)
        self.idxs = list(range(len(self.dataset)))
        self.chunks = geometry.chunk_partition(self.idxs, chunk_size)

    @property
    def tpi(self) -> int:
        return self.grid.tiles_per_image

    def __len__(self) -> int:
        return len(self.chunks)

    def shuffle(self) -> None:
        """Reshuffle the scene -> chunk assignment (once per epoch)."""
        self.rng.shuffle(self.idxs)
        self.chunks = geometry.chunk_partition(self.idxs, self.chunk_size)

    def specify(self, targets: list[int]) -> None:
        """Restrict to the given positions (debug)."""
        self.idxs = [self.idxs[i] for i in targets]
        self.chunks = geometry.chunk_partition(
            self.idxs, min(self.chunk_size, len(self.idxs)))

    def class_weights(self, num_classes: int, ignore_background: bool = False):
        return reader.class_weights(self.dataset.class_counts(num_classes),
                                    ignore_background)

    def class_priors(self, num_classes: int):
        return reader.class_priors(self.dataset.class_counts(num_classes))

    def _pad(self) -> int:
        return SHIFT_OFFSET + 12 if self.random_shift else 0

    def _load_scene_stack(self, scene_ids: list[int], pad: int):
        imgs = [self.dataset.load_image(i)[..., :self.in_channels]
                for i in scene_ids]
        msks = [self.dataset.load_index_mask(i) for i in scene_ids]
        images = extract.pad_scenes(np.stack(imgs), pad)
        masks = extract.pad_scenes(np.stack(msks), pad)
        return (torch.from_numpy(images).to(self.device),
                torch.from_numpy(masks).to(self.device))

    def get_chunk(self, c: int, random_tps=None,
                  shuffle_patches: bool = True) -> DeviceChunk:
        """Chunk ``c``'s patches on the device: tiles (shifted when
        ``random_shift``), augmented when configured, permuted."""
        if random_tps:
            extract.extract_resized()
        scene_ids = self.chunks[c]
        pad = self._pad()
        images, masks = self._load_scene_stack(scene_ids, pad)
        origins = self.grid.origins()
        coords = np.concatenate([
            np.concatenate([np.full((self.tpi, 1), s), origins], axis=1)
            for s in range(len(scene_ids))]).astype(np.int32)
        if self.random_shift:
            coords[:, 1:] += self.rng.integers(
                -SHIFT_OFFSET, SHIFT_OFFSET + 1,
                size=(len(coords), 2)).astype(np.int32)
        coords[:, 1:] += pad
        cc = torch.from_numpy(coords).to(self.device)
        p = self.patch_size
        patch_imgs = extract.slice_windows(images, cc, p)
        patch_msks = extract.slice_windows(masks, cc, p)
        if self.augment is not None:
            patch_imgs, patch_msks = augment_chunk(
                patch_imgs, patch_msks, self.augment, self.aug_gen)
        if shuffle_patches:
            perm = torch.from_numpy(
                self.rng.permutation(patch_imgs.shape[0])).to(self.device)
            patch_imgs = patch_imgs[perm]
            patch_msks = patch_msks[perm]
        return DeviceChunk(patch_imgs.contiguous(),
                           patch_msks.to(torch.int32))
