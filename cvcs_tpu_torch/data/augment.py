"""Device-resident augmentation of a chunk's patches (port of
``cvcs_tpu/data/augment.py``). Images go in and come out uint8; masks are
integer labels.

Two presets:

* ``mode="fused"`` (``augmentation: fused``): :func:`fused_dihedral_augment`
  runs the fused CUDA kernel (flips, rot90, contrast jitter;
  :mod:`cvcs_tpu_torch.ops.augment`), rounds back to uint8, and gives the
  label masks the same dihedral transform;
* ``mode="reference"`` (``augmentation: True``): :func:`augment_batch`,
  the reference's torchvision preset in plain torch: contrast jitter,
  Gaussian blur with reflect padding, and a free-angle nearest-neighbour
  rotation of image and mask with zero fill. The JAX package runs it in
  XLA, with no Pallas kernel.

The functions take their random draws as arguments, so tests can feed the
same numpy draws to both packages; ``draw_*`` make them from a
``torch.Generator`` on the device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from cvcs_tpu_torch.ops.augment import dihedral, draw_dihedral, fused_augment


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The reference's ``load_basic_transforms`` preset, or (``mode=
    "fused"``) the one-pass dihedral + contrast preset."""

    contrast: float = 0.6
    blur_kernel: int = 5
    blur_sigma: tuple[float, float] = (0.01, 20.0)
    rotation_degrees: float = 30.0
    mode: str = "reference"   # "reference" | "fused"


def plane_mean(plane: torch.Tensor) -> torch.Tensor:
    """(B,) means of (B, H, W) f32, taken as JAX's ``jnp.mean`` takes
    them: the sum times the f32 reciprocal of H * W, on every device
    (torch's mean divides on the CPU, which rounds differently)."""
    return plane.sum(dim=(1, 2)) * (1.0 / (plane.shape[1] * plane.shape[2]))


def adjust_contrast(image: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """torchvision ``adjust_contrast`` on (B, H, W, C) f32 in [0, 255]:
    blend with the mean (:func:`plane_mean`) of the floored ITU-R 601
    grayscale of the first three bands, clip, floor."""
    gray = (0.2989 * image[..., 0] + 0.587 * image[..., 1]
            + 0.114 * image[..., 2])
    mean = plane_mean(torch.floor(gray)).view(-1, 1, 1, 1)
    f = factor.view(-1, 1, 1, 1)
    return torch.floor(torch.clamp(f * image + (1.0 - f) * mean, 0.0, 255.0))


def gaussian_blur(image: torch.Tensor, sigma: torch.Tensor,
                  kernel: int = 5) -> torch.Tensor:
    """Separable k-tap Gaussian blur with reflect padding, (B, H, W, C) f32,
    one sigma per sample."""
    half = kernel // 2
    taps = torch.arange(-half, half + 1, dtype=torch.float32,
                        device=image.device)
    k = torch.exp(-0.5 * (taps / sigma.view(-1, 1)) ** 2)
    k = k / k.sum(-1, keepdim=True)                      # (B, kernel)

    def conv_axis(img, axis):          # axis 1 (rows) or 2 (cols)
        n = img.shape[axis]
        idx = torch.arange(-half, n + half, device=img.device).abs()
        idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)   # reflect
        padded = img.index_select(axis, idx)
        out = torch.zeros_like(img)
        for i in range(kernel):
            out = out + k[:, i].view(-1, 1, 1, 1) * padded.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(image, 1), 2)


def rotate_nearest(image: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate (B, H, W, C) by ``angle_deg`` counter-clockwise about the
    centre, nearest neighbour, zero fill (torch ``RandomRotation``'s
    defaults)."""
    b, h, w = image.shape[:3]
    dev = image.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = (torch.arange(h, dtype=torch.float32, device=dev) - cy).view(1, h, 1)
    xx = (torch.arange(w, dtype=torch.float32, device=dev) - cx).view(1, 1, w)
    a = (angle_deg.to(torch.float32) * (math.pi / 180)).view(b, 1, 1)
    cos, sin = torch.cos(a), torch.sin(a)
    # inverse map: output pixel (y, x) samples the source rotated by -angle
    iy = torch.round(cos * yy - sin * xx + cy).to(torch.int64)
    ix = torch.round(sin * yy + cos * xx + cx).to(torch.int64)
    valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    bi = torch.arange(b, device=dev).view(b, 1, 1)
    got = image[bi, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(valid.unsqueeze(-1), got, torch.zeros_like(got))


def draw_reference(b: int, config: AugmentConfig,
                   generator: torch.Generator):
    """Per-patch (contrast factors, blur sigmas, rotation angles)."""
    dev = generator.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator, device=dev)

    return (uniform(max(0.0, 1.0 - config.contrast), 1.0 + config.contrast),
            uniform(*config.blur_sigma),
            uniform(-config.rotation_degrees, config.rotation_degrees))


def augment_batch(images, masks, factors, sigmas, angles,
                  config: AugmentConfig = AugmentConfig()):
    """The reference preset on (B, p, p, C) uint8 images and (B, p, p)
    masks: contrast, blur, then the joint rotation."""
    img = adjust_contrast(images.to(torch.float32), factors)
    img = gaussian_blur(img, sigmas, config.blur_kernel)
    img = rotate_nearest(img, angles)
    m = rotate_nearest(masks.unsqueeze(-1).to(torch.float32), angles)[..., 0]
    return (torch.clamp(torch.round(img), 0, 255).to(torch.uint8),
            m.to(masks.dtype))


def fused_dihedral_augment(images, masks, flips, rots, factors):
    """The fused preset: the kernel (identity normalisation), rounded to
    uint8; the masks get the same flips and rot90s."""
    c = images.shape[-1]
    dev = images.device
    out = fused_augment(images, flips, rots, factors,
                        torch.zeros(c, device=dev), torch.ones(c, device=dev))
    out_u8 = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out_u8, dihedral(masks, flips, rots)


def augment_chunk(images, masks, config: AugmentConfig,
                  generator: torch.Generator):
    """Draw from ``generator`` and apply ``config``'s preset."""
    b = images.shape[0]
    if config.mode == "fused":
        return fused_dihedral_augment(
            images, masks, *draw_dihedral(b, config.contrast, generator))
    if config.mode != "reference":
        raise ValueError(f"unknown augmentation mode {config.mode!r}")
    return augment_batch(images, masks, *draw_reference(b, config, generator),
                         config)
