"""Plain reference of the chunked training loader's semantics: the
patches and masks of a training chunk, worked out again from the raw
scenes the benchmark wrote.

The semantics (the CVCS reference's ``train.py`` loader, as the
repository's recipes run it, with its documented draws):

- one ``np.random.default_rng(seed)`` shuffles the scene list at each
  epoch, then, for each chunk of ``chunk_size`` consecutive scenes,
  draws a +-20 pixel shift (both axes, inclusive) for every tile of the
  chunk's scenes, row-major per scene and scene after scene, then a
  permutation of the chunk's patches;
- a patch is the p x p crop at its shifted tile origin, reading zeros
  outside the scene; its mask is the same crop of the index mask;
- the augmentation draws come from a ``torch.Generator`` on the device
  seeded ``seed ^ 0x5EED``, one draw per patch in tile order (before the
  permutation):

  * ``fused``: flips and quarter turns uniform in 0..3, contrast factors
    uniform in [max(0, 1 - 0.6), 1 + 0.6); a patch is flipped left-right
    (bit 0), up-down (bit 1), turned counter-clockwise a quarter turn
    that many times (mask alike), then contrast-jittered: blended with
    the mean of its floored ITU-R 601 grayscale, clipped to 0..255 and
    floored;
  * ``recipe`` (torchvision's preset: ColorJitter(contrast 0.6),
    GaussianBlur(5, (0.01, 20)), RandomRotation(30)): contrast factors,
    blur sigmas and angles, each uniform in its range; contrast as
    above, a separable 5-tap Gaussian blur with reflected borders, then
    a nearest-neighbour rotation about the centre, counter-clockwise,
    zero outside (mask alike), rounded to uint8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SHIFT = 20
CONTRAST = 0.6
BLUR_TAPS = 5
BLUR_SIGMA = (0.01, 20.0)
ROTATION = 30.0


def _uniform(lo: float, hi: float, n: int, gen: torch.Generator):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=gen.device)


def draws(n: int, preset: str, seed: int, device):
    """The augmentation draws of a chunk of ``n`` patches, in tile order."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    if preset == "fused":
        flips = torch.randint(0, 4, (n,), generator=gen, device=device,
                              dtype=torch.int32)
        rots = torch.randint(0, 4, (n,), generator=gen, device=device,
                             dtype=torch.int32)
        return flips, rots, _uniform(max(0.0, 1.0 - CONTRAST),
                                     1.0 + CONTRAST, n, gen)
    if preset == "recipe":
        return (_uniform(max(0.0, 1.0 - CONTRAST), 1.0 + CONTRAST, n, gen),
                _uniform(*BLUR_SIGMA, n, gen),
                _uniform(-ROTATION, ROTATION, n, gen))
    raise ValueError(f"unknown preset {preset!r}")


def contrast(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """(B, P, P, C) float32 -> blended with the mean floored grayscale,
    clipped, floored."""
    gray = torch.floor(0.2989 * x[..., 0] + 0.587 * x[..., 1]
                       + 0.114 * x[..., 2])
    # the mean as the loader's documentation takes it: the sum times the
    # float32 reciprocal of the pixel count
    mean = (gray.sum((1, 2)) * (1.0 / (gray.shape[1] * gray.shape[2]))).view(
        -1, 1, 1, 1)
    f = factor.view(-1, 1, 1, 1)
    return torch.floor(torch.clamp(f * x + (1.0 - f) * mean, 0.0, 255.0))


def flip_turn(x: torch.Tensor, flip: int, turns: int) -> torch.Tensor:
    """One (P, P, ...) patch flipped and turned counter-clockwise."""
    if flip & 1:
        x = torch.flip(x, (1,))
    if flip & 2:
        x = torch.flip(x, (0,))
    return torch.rot90(x, turns % 4, (0, 1))


def blur(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur, 5 taps, reflected borders, one sigma a
    patch; (B, P, P, C) float32."""
    half = BLUR_TAPS // 2
    taps = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=x.device)
    k = torch.exp(-0.5 * (taps / sigma.view(-1, 1)) ** 2)
    k = k / k.sum(-1, keepdim=True)
    for axis in (1, 2):
        n = x.shape[axis]
        idx = torch.arange(-half, n + half, device=x.device).abs()
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)
        padded = x.index_select(axis, idx)
        out = torch.zeros_like(x)
        for i in range(BLUR_TAPS):
            out = out + k[:, i].view(-1, 1, 1, 1) * padded.narrow(axis, i, n)
        x = out
    return x


def rotate(x: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) turned counter-clockwise by ``angle`` degrees about
    the centre ((H - 1) / 2, (W - 1) / 2): each output pixel takes the
    nearest source pixel of the inverse rotation, zero outside."""
    b, h, w = x.shape[:3]
    dev = x.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy).view(1, h, 1)
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx).view(1, 1, w)
    a = (angle.to(torch.float32) * (math.pi / 180)).view(b, 1, 1)
    cos, sin = torch.cos(a), torch.sin(a)
    sy = torch.round(cos * yy - sin * xx + cy).to(torch.int64)
    sx = torch.round(sin * yy + cos * xx + cx).to(torch.int64)
    inside = (sy >= 0) & (sy < h) & (sx >= 0) & (sx < w)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    got = x[bi, sy.clamp(0, h - 1), sx.clamp(0, w - 1)]
    return torch.where(inside.unsqueeze(-1), got, torch.zeros_like(got))


def chunk_patches(images: list, masks: list, seed: int, p: int,
                  chunk_size: int, take: int, preset: str, device):
    """The first ``take`` patches of the first epoch's first chunk, in
    the chunk's order: (images (take, p, p, C) uint8, masks (take, p, p)
    int64), on ``device``."""
    rng = np.random.default_rng(seed)
    order = list(range(len(images)))
    rng.shuffle(order)
    scenes = order[:chunk_size]
    h, w = images[0].shape[:2]
    rows, cols = h // p, w // p
    tiles = np.array([(s, r * p, c * p) for s in range(len(scenes))
                      for r in range(rows) for c in range(cols)])
    tiles[:, 1:] += rng.integers(-SHIFT, SHIFT + 1, size=(len(tiles), 2))
    sel = rng.permutation(len(tiles))[:take]
    pads = [np.pad(images[i], ((SHIFT, SHIFT), (SHIFT, SHIFT), (0, 0)))
            for i in scenes]
    mpads = [np.pad(masks[i], SHIFT) for i in scenes]
    img = np.stack([pads[s][y + SHIFT:y + SHIFT + p, x + SHIFT:x + SHIFT + p]
                    for s, y, x in tiles[sel]])
    msk = np.stack([mpads[s][y + SHIFT:y + SHIFT + p,
                             x + SHIFT:x + SHIFT + p]
                    for s, y, x in tiles[sel]])
    img = torch.from_numpy(img).to(device)
    msk = torch.from_numpy(msk).to(device).long()
    d = [a[torch.from_numpy(sel).to(device)]
         for a in draws(len(tiles), preset, seed, device)]
    if preset == "fused":
        flips, turns, factors = d[0].tolist(), d[1].tolist(), d[2]
        img = torch.stack([flip_turn(img[i], flips[i], turns[i])
                           for i in range(take)])
        msk = torch.stack([flip_turn(msk[i], flips[i], turns[i])
                           for i in range(take)])
        out = contrast(img.float(), factors)
    else:
        factors, sigmas, angles = d
        out = rotate(blur(contrast(img.float(), factors), sigmas), angles)
        msk = rotate(msk[..., None].float(), angles)[..., 0].long()
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8), msk
