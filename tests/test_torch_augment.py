"""Port's augmentation (plain K5 and the presets of ``data/augment.py``, as
they run on CPU tensors) vs the JAX package's.

The random draws are made once and fed to both packages: for the fused
preset, the flips, rot90 counts and contrast factors that JAX's
``fused_dihedral_augment`` draws from its key (recomputed here with the
same ``jax.random`` calls); for the reference preset, numpy draws.

Tolerances. K5 images: equal elements except near floor boundaries, where
a product rounded differently lands one level apart: at least 99.9% equal
and the rest within 1/std (observed: all equal; for patches up to 256 x
256 the grayscale mean is an exact f32 sum of integers). Masks: bit-equal.
Reference preset: contrast and blur within 1e-3 (f32, separate
elementwise ops on both sides); the nearest-neighbour rotation lands on
the same source pixel for at least 99% of pixels (cos/sin of the two
libraries may differ in the last bit and flip a rounding at .5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.data import augment as jaug
from cvcs_tpu.ops.pallas_augment import fused_augment as jax_fused_augment
from cvcs_tpu_torch.data import augment as taug
from cvcs_tpu_torch.ops import augment as tops


def _images(b, p, c, seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, p, p, c), dtype=np.uint8)
    masks = rng.integers(0, 16, (b, p, p)).astype(np.int32)
    return img, masks


def _assert_k5_close(got, want, std):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.999
    assert (np.abs(got - want) <= 1.0 / np.asarray(std) + 1e-6).all()


@pytest.mark.parametrize("c", [3, 4])
def test_plain_kernel_matches_jax(c):
    b, p = 16, 32
    img, _ = _images(b, p, c, seed=c)
    rng = np.random.default_rng(10 + c)
    flips = np.arange(b) % 4                  # every flip x rot combination
    rots = (np.arange(b) // 4) % 4
    factors = rng.uniform(0.4, 1.6, b).astype(np.float32)
    mean = rng.uniform(50, 150, c).astype(np.float32)
    std = rng.uniform(20, 80, c).astype(np.float32)
    want = jax_fused_augment(
        jnp.asarray(img), jnp.asarray(flips, jnp.int32),
        jnp.asarray(rots, jnp.int32), jnp.asarray(factors), jnp.asarray(mean),
        jnp.asarray(std), interpret=True)
    before = tops.launches
    got = tops.fused_augment(
        torch.from_numpy(img), torch.from_numpy(flips).int(),
        torch.from_numpy(rots).int(), torch.from_numpy(factors),
        torch.from_numpy(mean), torch.from_numpy(std))
    assert tops.launches == before        # the plain version: no launch
    assert got.dtype == torch.float32
    _assert_k5_close(got.numpy(), want, std)


@pytest.mark.parametrize("c", [3, 4])
def test_fused_dihedral_preset_matches_jax(c):
    b, p = 12, 32
    img, masks = _images(b, p, c, seed=20 + c)
    key = jax.random.key(5 + c)
    want_img, want_msk = jaug.fused_dihedral_augment(
        jnp.asarray(img), jnp.asarray(masks), key)
    # the draws JAX made from the key, fed to the port
    k1, k2, k3 = jax.random.split(key, 3)
    flips = np.asarray(jax.random.randint(k1, (b,), 0, 4))
    rots = np.asarray(jax.random.randint(k2, (b,), 0, 4))
    factors = np.asarray(jax.random.uniform(k3, (b,), minval=0.4,
                                            maxval=1.6))
    got_img, got_msk = taug.fused_dihedral_augment(
        torch.from_numpy(img), torch.from_numpy(masks),
        torch.from_numpy(flips), torch.from_numpy(rots),
        torch.from_numpy(factors))
    assert got_img.dtype == torch.uint8 and got_msk.dtype == torch.int32
    _assert_k5_close(got_img.numpy().astype(np.float32),
                     np.asarray(want_img, np.float32), np.ones(c))
    np.testing.assert_array_equal(got_msk.numpy(), np.asarray(want_msk))


def test_dihedral_is_flip_then_rot90():
    """All 16 (flip, rot) pairs against numpy's flips and rot90."""
    x = np.arange(2 * 5 * 5).reshape(2, 5, 5)
    for f in range(4):
        for r in range(4):
            want = x[:, :, ::-1] if f & 1 else x
            want = want[:, ::-1] if f & 2 else want
            want = np.rot90(want, r, axes=(1, 2))
            got = tops.dihedral(torch.from_numpy(x), torch.full((2,), f),
                                torch.full((2,), r))
            np.testing.assert_array_equal(got.numpy(), want)


def test_reference_preset_matches_jax():
    b, p = 4, 32
    img, masks = _images(b, p, 3, seed=40)
    rng = np.random.default_rng(41)
    factors = rng.uniform(0.4, 1.6, b).astype(np.float32)
    sigmas = rng.uniform(0.01, 20.0, b).astype(np.float32)
    angles = rng.uniform(-30, 30, b).astype(np.float32)
    imgf = img.astype(np.float32)

    j_con = jax.vmap(jaug.adjust_contrast)(jnp.asarray(imgf),
                                           jnp.asarray(factors))
    t_con = taug.adjust_contrast(torch.from_numpy(imgf),
                                 torch.from_numpy(factors))
    np.testing.assert_allclose(t_con.numpy(), np.asarray(j_con), atol=1e-3)

    j_blur = jax.vmap(jaug.gaussian_blur)(j_con, jnp.asarray(sigmas))
    t_blur = taug.gaussian_blur(torch.from_numpy(np.asarray(j_con)),
                                torch.from_numpy(sigmas))
    np.testing.assert_allclose(t_blur.numpy(), np.asarray(j_blur), atol=1e-3)

    j_rot = jax.vmap(jaug.rotate_nearest)(jnp.asarray(imgf),
                                          jnp.asarray(angles))
    t_rot = taug.rotate_nearest(torch.from_numpy(imgf),
                                torch.from_numpy(angles))
    assert (t_rot.numpy() == np.asarray(j_rot)).all(-1).mean() >= 0.99

    # the whole preset, with the draws JAX's augment_batch makes
    key = jax.random.key(42)
    want_img, want_msk = jaug.augment_batch(jnp.asarray(img),
                                            jnp.asarray(masks), key)
    cfg = jaug.AugmentConfig()
    kc, ks, ka = jax.random.split(key, 3)
    draws = [np.asarray(jax.random.uniform(k, (b,), minval=lo, maxval=hi))
             for k, (lo, hi) in ((kc, (0.4, 1.6)), (ks, cfg.blur_sigma),
                                 (ka, (-30.0, 30.0)))]
    got_img, got_msk = taug.augment_batch(
        torch.from_numpy(img), torch.from_numpy(masks),
        *[torch.from_numpy(d) for d in draws])
    assert got_img.dtype == torch.uint8
    diff = np.abs(got_img.numpy().astype(int)
                  - np.asarray(want_img).astype(int))
    assert (diff <= 1).mean() >= 0.99
    assert (got_msk.numpy() == np.asarray(want_msk)).mean() >= 0.99


def test_draws_come_from_the_generator():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = tops.draw_dihedral(64, 0.6, g1)
    b = tops.draw_dihedral(64, 0.6, g2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    flips, rots, factors = a
    assert flips.dtype == rots.dtype == torch.int32
    assert 0 <= int(flips.min()) and int(flips.max()) <= 3
    assert 0 <= int(rots.min()) and int(rots.max()) <= 3
    assert 0.4 <= float(factors.min()) and float(factors.max()) < 1.6
    ref = taug.draw_reference(64, taug.AugmentConfig(), g1)
    assert all(d.shape == (64,) for d in ref)


@pytest.mark.parametrize("draw", range(16))
def test_plain_kernel_matches_jax_each_draw(draw):
    """Each (flip, rot90) draw on its own, at P 12: 144 pixels, whose
    reciprocal is not exact in f32, so the mean's rounding shows. This is
    the reference the card's kernel-vs-plain check leans on. The rule is
    the module's: XLA on the CPU contracts the blend into a fused
    multiply-add, which torch's separate ops do not, and an element near a
    floor boundary may land one level apart."""
    b, p, c = 16, 12, 3
    img, _ = _images(b, p, c, seed=60 + draw)
    flips = np.full(b, draw // 4)
    rots = np.full(b, draw % 4)
    factors = np.linspace(0.4, 1.6, b).astype(np.float32)
    mean = np.array([70.0, 90.0, 110.0], np.float32)
    std = np.array([30.0, 45.0, 60.0], np.float32)
    want = jax_fused_augment(
        jnp.asarray(img), jnp.asarray(flips, jnp.int32),
        jnp.asarray(rots, jnp.int32), jnp.asarray(factors), jnp.asarray(mean),
        jnp.asarray(std), interpret=True)
    got = tops.fused_augment(
        torch.from_numpy(img), torch.from_numpy(flips).int(),
        torch.from_numpy(rots).int(), torch.from_numpy(factors),
        torch.from_numpy(mean), torch.from_numpy(std))
    _assert_k5_close(got.numpy(), want, std)


def dihedral_map(flip: int, rot: int, p: int) -> tuple:
    """``csrc/augment.cu``'s dihedral map as integer coefficients: output pixel
    (y, x) of a (flip, rot) patch reads source (oy + yy*y + yx*x,
    ox + xy*y + xx*x); rot90 x k first, then the flips, as :func:`dihedral`.
    Returns (oy, yy, yx, ox, xy, xx)."""
    pm = p - 1
    k = min(max(rot, 0), 3)
    oy, yy, yx, ox, xy, xx = ((0, 1, 0, 0, 0, 1), (0, 0, 1, pm, -1, 0),
                              (pm, -1, 0, pm, 0, -1), (pm, 0, -1, 0, 1, 0))[k]
    if flip & 2:
        oy, yy, yx = pm - oy, -yy, -yx
    if flip & 1:
        ox, xy, xx = pm - ox, -xy, -xx
    return oy, yy, yx, ox, xy, xx


def source_band(y0: int, y1: int, p: int, flip: int, rot: int):
    """The source region that output rows [y0, y1) of a (flip, rot) patch
    read: ``("rows", s0, s1)`` (even rot90 counts) or ``("cols", s0, s1)``
    (odd ones), as ``csrc/augment.cu`` stages it (``stage_piece``)."""
    oy, yy, _, ox, xy, _ = dihedral_map(flip, rot, p)
    odd = yy == 0
    o, d = (ox, xy) if odd else (oy, yy)
    s0 = o + y0 if d > 0 else o - (y1 - 1)
    return ("cols" if odd else "rows", s0, s0 + (y1 - y0))


PLAN_SIZES = [(p, c) for p in (1, 2, 5, 7, 8, 9, 33, 97, 224, 256, 512, 513,
                               2048, 3100, 8192)
              for c in (1, 2, 3, 4, 13, 17)]


def test_band_plan_covers_every_row_once():
    """The CTAs' bands, and the staged pieces of each band, cover the
    output rows exactly once; the staged region fits its budget and the
    whole plan fits a CTA's shared memory."""
    for p, c in PLAN_SIZES:
        plan = tops.band_plan(p, c)
        assert 1 <= plan["cluster"] <= tops.MAX_CLUSTER
        covered = np.zeros(p, int)
        for r in range(plan["cluster"]):
            y0 = min(p, r * plan["band_rows"])
            y1 = min(p, y0 + plan["band_rows"])
            piece = plan["stage_rows"] or max(y1 - y0, 1)
            for ys in range(y0, y1, piece):
                covered[ys:min(y1, ys + piece)] += 1
        assert (covered == 1).all(), (p, c)
        rows = plan["stage_rows"]
        if rows:
            assert tops._stage_bytes(rows, p, c) <= tops.STAGE_BUDGET
        if rows < plan["band_rows"]:      # the most rows within the budget
            assert tops._stage_bytes(rows + 1, p, c) > tops.STAGE_BUDGET
        assert plan["smem"] <= 227 * 1024


@pytest.mark.parametrize("p", [7, 12, 33])
def test_band_preimages_partition_the_source(p):
    """Under each of the 16 draws (8 dihedral maps), the source pixels that
    a band of output rows reads are exactly the region the kernel stages
    (a row band for even rot90 counts, a column band for odd), and the
    bands' regions partition the patch."""
    plan = tops.band_plan(p, 1)
    index = torch.arange(p * p).view(1, p, p)
    for flip in range(4):
        for rot in range(4):
            src = tops.dihedral(index, torch.tensor([flip]),
                                torch.tensor([rot]))[0]
            seen = np.zeros(p * p, int)
            for r in range(plan["cluster"]):
                y0 = min(p, r * plan["band_rows"])
                y1 = min(p, y0 + plan["band_rows"])
                read = src[y0:y1].flatten().numpy()
                seen[read] += 1
                kind, s0, s1 = source_band(y0, y1, p, flip, rot)
                region = np.zeros((p, p), bool)
                if kind == "rows":
                    region[s0:s1] = True
                else:
                    region[:, s0:s1] = True
                assert set(read) == set(np.flatnonzero(region))
            assert (seen == 1).all()


def test_fused_augment_rejects_what_the_kernel_does_not_take():
    img = torch.zeros(2, 8, 8, 3, dtype=torch.uint8)
    z2, ones = torch.zeros(2), torch.ones(3)
    before = tops.launches
    with pytest.raises(TypeError, match="uint8"):
        tops.fused_augment(img.float(), z2, z2, z2, ones, ones)
    with pytest.raises(ValueError, match="images must be"):
        tops.fused_augment(img[:, :4], z2, z2, z2, ones, ones)
    with pytest.raises(ValueError, match="rots must be"):
        tops.fused_augment(img, z2, torch.zeros(3), z2, ones, ones)
    with pytest.raises(ValueError, match="band_std must be"):
        tops.fused_augment(img, z2, z2, z2, ones, torch.ones(4))
    assert tops.launches == before
