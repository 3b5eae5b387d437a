"""Chunked training/eval data loading (port of ``cvcs_tpu/data/loader.py``).

The host decodes a chunk's scenes once (PIL -> numpy uint8), pads them and
ships them to the device; every crop, resize and augmentation happens
there. A chunk holds all its patches (the tiles, then the ``random_tps``
crops) and, with ``load_context``, their context windows as contiguous
uint8 device tensors, and serves fixed-shape batches as slices.

As in the JAX loader (and the reference): the context and shift paddings
add; a context is the 3p window around its tile resized to p, is not
augmented and is permuted with its patch; ``random_tps`` entries
``[crop size, share of tiles]`` append crops of that size from random
origins of the chunk's scenes, resized to p, which skip augmentation, and
whose context is the fixed 3p window at the crop's origin (the
reference's quirk, kept). Contexts and crops are gathered in slabs of
``SLAB`` patches, which bounds the f32 working set of their resize (a 3p
window is nine tiles).

Randomness follows the JAX loader draw for draw: one
``np.random.default_rng(seed)`` drives the per-epoch scene shuffle, the
+-20 px tile shifts, each ``random_tps`` entry's scene, row and column
draws and the per-chunk patch permutation, in the same order, so for one
seed the chunks equal the JAX loader's up to augmentation. Augmentation
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
SLAB = 256         # patches per context / crop gather


@dataclasses.dataclass
class Batch:
    """One micro-batch on the device, NHWC uint8 imagery."""

    image: torch.Tensor                   # (B, p, p, C) uint8
    mask: torch.Tensor                    # (B, p, p) int32
    context: torch.Tensor | None = None   # (B, p, p, C) uint8
    valid: torch.Tensor | None = None     # (B,) bool, False for padding


class DeviceChunk:
    """A chunk's patches on the device."""

    def __init__(self, images: torch.Tensor, masks: torch.Tensor,
                 contexts: torch.Tensor | None = None):
        self.images = images
        self.masks = masks
        self.contexts = contexts

    def _ctx(self, sl):
        return None if self.contexts is None else self.contexts[sl]

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
            yield Batch(self.images[sl], self.masks[sl], self._ctx(sl))
        rem = n - full * batch_size
        if rem and not drop_last:
            if pad_tail:
                yield self._tail_batch(batch_size, full, rem)
            else:
                sl = slice(full * batch_size, n)
                yield Batch(self.images[sl], self.masks[sl], self._ctx(sl))

    def _tail_batch(self, batch_size: int, full: int, rem: int) -> Batch:
        n = len(self)
        dev = self.images.device
        idx = torch.cat([torch.arange(full * batch_size, n, device=dev),
                         torch.zeros(batch_size - rem, dtype=torch.int64,
                                     device=dev)])
        return Batch(self.images[idx], self.masks[idx], self._ctx(idx),
                     valid=torch.arange(batch_size, device=dev) < rem)


class ChunkLoader:
    """Drives chunked loading of a GID15-style dataset root."""

    def __init__(self, root: str, chunk_size: int = 2, patch_size: int = 224,
                 random_shift: bool = False,
                 augment: AugmentConfig | None = None,
                 load_context: bool = False, in_channels: int = 3,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.dataset = reader.SceneDataset(root)
        self.patch_size = patch_size
        self.chunk_size = chunk_size
        self.random_shift = random_shift
        self.augment = augment
        self.load_context = load_context
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
        # the paddings add: a shifted tile sits up to SHIFT_OFFSET outside
        # the grid, and its context window reaches a patch beyond that
        pad = self.patch_size if self.load_context else 0
        if self.random_shift:
            pad += SHIFT_OFFSET + 12
        return pad

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
        ``random_shift``), augmented when configured, then the
        ``random_tps`` crops, with their contexts when ``load_context``,
        permuted."""
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
        contexts = [self._contexts(images, cc)] if self.load_context else []
        if self.augment is not None:
            patch_imgs, patch_msks = augment_chunk(
                patch_imgs, patch_msks, self.augment, self.aug_gen)
        patch_imgs, patch_msks = [patch_imgs], [patch_msks]
        for aug_size, share in random_tps or ():
            tc = self._tps_coords(len(coords), aug_size, share,
                                  len(scene_ids), pad)
            if tc is None:
                continue
            for s in range(0, len(tc), SLAB):
                img, msk = extract.extract_resized(
                    images, masks, tc[s:s + SLAB], aug_size, p)
                patch_imgs.append(img)
                patch_msks.append(msk)
            if self.load_context:
                contexts.append(self._contexts(images, tc))
        patch_imgs = torch.cat(patch_imgs)
        patch_msks = torch.cat(patch_msks)
        contexts = torch.cat(contexts) if contexts else None
        if shuffle_patches:
            perm = torch.from_numpy(
                self.rng.permutation(patch_imgs.shape[0])).to(self.device)
            patch_imgs = patch_imgs[perm]
            patch_msks = patch_msks[perm]
            if contexts is not None:
                contexts = contexts[perm]
        return DeviceChunk(patch_imgs.contiguous(),
                           patch_msks.to(torch.int32),
                           None if contexts is None else contexts.contiguous())

    def _contexts(self, images: torch.Tensor, cc: torch.Tensor):
        """The context windows at ``cc``'s origins, a slab at a time."""
        return torch.cat([
            extract.extract_context(images, cc[s:s + SLAB], self.patch_size)
            for s in range(0, len(cc), SLAB)])

    def _tps_coords(self, n_tiles: int, aug_size: int, share: float,
                    n_scenes: int, pad: int):
        """One ``random_tps`` entry's crop origins (padded coordinates) on
        the device, or None when it asks for no crop; the JAX loader's
        draws, in its order."""
        n_extra = int(share * n_tiles)
        if n_extra == 0:
            return None
        h, w = self.image_shape
        if aug_size >= min(h, w):
            raise ValueError(f"random_tps size {aug_size} must be smaller "
                             f"than the scene ({h}x{w})")
        sc = self.rng.integers(0, n_scenes, size=(n_extra, 1))
        # origins in [0, h-1-aug_size], the reference's inclusive randint
        ys = self.rng.integers(0, h - aug_size, size=(n_extra, 1))
        xs = self.rng.integers(0, w - aug_size, size=(n_extra, 1))
        tc = np.concatenate([sc, ys + pad, xs + pad], axis=1)
        return torch.from_numpy(tc.astype(np.int32)).to(self.device)
