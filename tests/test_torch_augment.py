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
