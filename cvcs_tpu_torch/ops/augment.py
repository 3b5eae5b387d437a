"""Fused augmentation + normalisation in one CUDA kernel (K5).

Replaces the Pallas TPU kernel ``fused_augment`` / ``_augment_kernel`` of
``cvcs_tpu/ops/pallas_augment.py``. The kernel is ``csrc/augment.cu``,
CUDA C++ for ``sm_90a``, built with ``nvcc`` at first use and bound with
ctypes (see :mod:`._build`). Its source says what it computes, what
bounds it (memory) and its design: a thread-block cluster per patch, one
CTA per band of output rows, each staging in shared memory the source
region its band maps from, the grayscale mean summed from the same staged
bytes and exchanged through distributed shared memory, then 16-byte
stores. One op call is one CUDA kernel, ``augment_kernel``.

:func:`fused_augment` launches the kernel for a CUDA tensor and raises on
what it does not take; for a CPU tensor it runs
:func:`fused_augment_plain`, the same function in plain torch. The random
draws (flips, rot90 counts, contrast factors) are arguments, as in the
JAX kernel; :func:`draw_dihedral` makes them from a ``torch.Generator``.
:func:`band_plan` is the kernel's launch plan, the same arithmetic as
``make_plan`` in the source. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

KERNEL = dict(
    name="fused_augment",
    route="cuda",
    source="cvcs_tpu_torch/csrc/augment.cu",
    replaces="cvcs_tpu/ops/pallas_augment.py:132",
)

launches = 0         # kernel launches since the caller last reset it


def dihedral(x: torch.Tensor, flips, rots) -> torch.Tensor:
    """Per-sample flips then k x 90 degree counter-clockwise rotations of
    (B, P, P, ...) ``x``: flip left-right when ``flips`` bit 0 is set,
    up-down when bit 1 is, then ``jnp.rot90``/``torch.rot90`` over the two
    spatial axes ``rots`` times (clipped to 0..3), as a gather."""
    b, p = x.shape[0], x.shape[1]
    dev = x.device
    i = torch.arange(p, device=dev).view(1, p, 1)
    j = torch.arange(p, device=dev).view(1, 1, p)
    k = rots.to(device=dev, dtype=torch.int64).clamp(0, 3).view(b, 1, 1)
    fl = flips.to(device=dev, dtype=torch.int64).view(b, 1, 1)
    pm = p - 1
    # output (i, j) of rot90^k reads the flipped patch at (sy, sx)
    sy = torch.where(k == 0, i, torch.where(k == 1, j, torch.where(
        k == 2, pm - i, pm - j)))
    sx = torch.where(k == 0, j, torch.where(k == 1, pm - i, torch.where(
        k == 2, pm - j, i)))
    sy = torch.where((fl >> 1) & 1 == 1, pm - sy, sy)
    sx = torch.where(fl & 1 == 1, pm - sx, sx)
    return x[torch.arange(b, device=dev).view(b, 1, 1), sy, sx]


def fused_augment_plain(images, flips, rots, factors, band_mean, band_std):
    """Plain torch twin of the kernel: (B, P, P, C) uint8 -> f32."""
    x = dihedral(images, flips, rots).to(torch.float32)
    c = x.shape[-1]
    gray = (0.2989 * x[..., 0] + 0.587 * x[..., 1 % c]
            + 0.114 * x[..., 2 % c])
    # the mean as XLA takes it in the JAX kernel (and torch's mean on the
    # card): the sum times the f32 reciprocal of the pixel count. torch's
    # mean on the CPU divides instead, which rounds differently.
    npix = x.shape[1] * x.shape[2]
    mean_g = (torch.floor(gray).sum(dim=(1, 2)) * (1.0 / npix)).view(
        -1, 1, 1, 1)
    f = factors.to(torch.float32).view(-1, 1, 1, 1)
    x = torch.floor(torch.clamp(f * x + (1.0 - f) * mean_g, 0.0, 255.0))
    return (x - band_mean.to(torch.float32)) / band_std.to(torch.float32)


# make_plan's constants in csrc/augment.cu
MAX_CLUSTER = 8                  # CTAs per patch: the portable cluster size
STAGE_BUDGET = 96 * 1024         # staged source bytes per CTA
LUT_MAX_C = 16                   # bands that get a full output table


def _seg_pitch(n: int) -> int:
    return -(-n // 16) * 16 + 16


def _stage_bytes(rows: int, p: int, c: int) -> int:
    """Shared memory that staging ``rows`` output rows takes: the larger
    of the even-rot90 region (``rows`` source rows) and the odd one (a
    column band: ``p`` source rows of ``rows`` pixels), each segment padded
    to its own 16-byte windows."""
    return max(rows * _seg_pitch(p * c), p * _seg_pitch(rows * c))


def band_plan(p: int, c: int) -> dict:
    """The kernel's launch plan for (P, C) patches: ``cluster`` CTAs per
    patch, CTA r owning output rows [r * band_rows, (r + 1) * band_rows)
    (clipped to P), staged ``stage_rows`` rows at a time (0: read from
    device memory, for patches too wide to stage one row), with
    ``smem`` bytes of dynamic shared memory (the output table, then the
    staged region)."""
    cluster = min(MAX_CLUSTER, p)
    band_rows = -(-p // cluster)
    rows = band_rows
    if _stage_bytes(rows, p, c) > STAGE_BUDGET:
        rows = max((r for r in range(band_rows + 1)
                    if r == 0 or _stage_bytes(r, p, c) <= STAGE_BUDGET))
    table = (c if c <= LUT_MAX_C else 1) * 256 * 4
    return dict(cluster=cluster, band_rows=band_rows, stage_rows=rows,
                smem=table + (_stage_bytes(rows, p, c) if rows else 0))


def draw_dihedral(b: int, contrast: float, generator: torch.Generator):
    """The preset's per-patch draws on the generator's device: flips and
    rot90 counts uniform in 0..3, contrast factors uniform in
    [max(0, 1 - contrast), 1 + contrast)."""
    dev = generator.device
    flips = torch.randint(0, 4, (b,), generator=generator, device=dev,
                          dtype=torch.int32)
    rots = torch.randint(0, 4, (b,), generator=generator, device=dev,
                         dtype=torch.int32)
    lo, hi = max(0.0, 1.0 - contrast), 1.0 + contrast
    factors = lo + (hi - lo) * torch.rand(b, generator=generator, device=dev)
    return flips, rots, factors


def _check(images, flips, rots, factors, band_mean, band_std):
    if images.dim() != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(f"images must be (B, P, P, C), got "
                         f"{tuple(images.shape)}")
    if images.dtype != torch.uint8:
        raise TypeError(f"fused_augment takes uint8 images, got {images.dtype}")
    b, _, _, c = images.shape
    for name, a, shape in (("flips", flips, (b,)), ("rots", rots, (b,)),
                           ("factors", factors, (b,)),
                           ("band_mean", band_mean, (c,)),
                           ("band_std", band_std, (c,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(a.shape)}")
        if a.device != images.device:
            raise ValueError(f"{name} is on {a.device}, images on "
                             f"{images.device}")


@functools.cache
def _kernel():
    """The C entry point of ``csrc/augment.cu``, built at first use."""
    from cvcs_tpu_torch.ops import _build

    fn = _build.load("augment").cvcs_fused_augment
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def kernel_plan(p: int, c: int) -> dict:
    """The plan the built kernel computes for (P, C) (``cvcs_augment_plan``
    of ``csrc/augment.cu``), to hold against :func:`band_plan`."""
    from cvcs_tpu_torch.ops import _build

    fn = _build.load("augment").cvcs_augment_plan
    fn.restype = None
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 4)()
    fn(p, c, out)
    return dict(zip(("cluster", "band_rows", "stage_rows", "smem"), out))


def fused_augment(images, flips, rots, factors, band_mean, band_std):
    """Augmented and normalised (B, P, P, C) f32 from (B, P, P, C) uint8.

    Args (the TPU op's, ``pallas_augment.fused_augment``): flips (B,)
    ints, bit 0 left-right and bit 1 up-down; rots (B,) rot90 counts;
    factors (B,) contrast factors; band_mean, band_std (C,).

    A CUDA tensor launches the kernel (or raises); a CPU tensor runs the
    plain version."""
    global launches
    _check(images, flips, rots, factors, band_mean, band_std)
    if images.device.type == "cpu":
        return fused_augment_plain(images, flips, rots, factors, band_mean,
                                   band_std)
    if images.device.type != "cuda":
        raise ValueError(f"no fused_augment kernel for device {images.device}")
    fn = _kernel()
    b, p, _, c = images.shape
    images = images.contiguous()
    args = [flips.to(torch.int32).contiguous(),
            rots.to(torch.int32).contiguous(),
            factors.to(torch.float32).contiguous(),
            band_mean.to(torch.float32).contiguous(),
            band_std.to(torch.float32).contiguous()]
    out = torch.empty(images.shape, dtype=torch.float32, device=images.device)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        rc = fn(images.data_ptr(), *[a.data_ptr() for a in args],
                out.data_ptr(), b, p, c, stream)
    if rc != 0:
        raise RuntimeError(f"fused_augment kernel launch failed: CUDA error {rc}")
    launches += 1
    return out
