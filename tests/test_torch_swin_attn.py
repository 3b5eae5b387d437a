"""Port's Swin window-attention op (plain version, as the wrapper runs it
on the CPU) vs the JAX package's fused op.

The same numpy draws go to both: JAX's ``fused_window_attention`` in
Pallas interpret mode and its jnp twin ``_reference_fused``, and the
port's ``swin_window_attention`` on CPU tensors. Every mask regime of
``tests/test_pallas_swin.py`` is covered: maskless, region (shifted),
pad-validity, combined, clamped single window, and win 7 (T = 49).

Tolerances: f32 leg atol = 1e-5 * max(1, |ref|max) (both sides f32, only
the summation order differs); bf16 leg 3e-2 * scale, as the JAX
package's own kernel test (rounding points can flip one bf16 ulp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models.swin import _attn_mask as jax_attn_mask
from cvcs_tpu.ops.pallas_swin import _reference_fused, fused_window_attention
from cvcs_tpu_torch.models.swin import _attn_mask, attn_bias
from cvcs_tpu_torch.ops import swin_attn

CASES = {
    "maskless": dict(b=2, h=8, w=8, h0=8, w0=8, c=16, heads=2, win=4, shift=0),
    "region": dict(b=2, h=8, w=12, h0=8, w0=12, c=16, heads=2, win=4, shift=2),
    "pad": dict(b=1, h=8, w=12, h0=7, w0=10, c=16, heads=2, win=4, shift=0),
    "combined": dict(b=2, h=8, w=12, h0=7, w0=10, c=16, heads=4, win=4,
                     shift=2),
    "single_window": dict(b=2, h=4, w=4, h0=4, w0=4, c=16, heads=2, win=4,
                          shift=0),
    "win7_t49": dict(b=1, h=14, w=14, h0=14, w0=14, c=32, heads=2, win=7,
                     shift=3),
}


def _draws(b, h, w, c, seed=0, **_):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, h, w, c)).astype(np.float32),
        ln_s=rng.standard_normal(c).astype(np.float32),
        ln_b=rng.standard_normal(c).astype(np.float32),
        wqkv=(rng.standard_normal((c, 3 * c)) * 0.1).astype(np.float32),
        bqkv=(rng.standard_normal(3 * c) * 0.1).astype(np.float32),
        wout=(rng.standard_normal((c, c)) * 0.1).astype(np.float32),
        bout=(rng.standard_normal(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_op_matches_jax_fused(case, dtype):
    cfg = CASES[case]
    a = _draws(**cfg)
    mask = jax_attn_mask(cfg["h"], cfg["w"], cfg["h0"], cfg["w0"],
                         cfg["win"], cfg["shift"])
    assert (mask is None) == (case in ("maskless", "single_window"))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    kw = dict(win=cfg["win"], heads=cfg["heads"])

    jargs = [jnp.asarray(a["x"], jdt)] + [
        jnp.asarray(a[k]) for k in ("ln_s", "ln_b", "wqkv", "bqkv", "wout",
                                    "bout")]
    ref_kernel = np.asarray(fused_window_attention(
        *jargs, mask, interpret=True, **kw), np.float32)
    jbias = (None if mask is None else
             jnp.asarray(np.where(mask, 0.0, -1e9).astype(np.float32)))
    ref_twin = np.asarray(_reference_fused(*jargs, jbias, **kw), np.float32)

    targs = [torch.from_numpy(a["x"]).to(tdt)] + [
        torch.from_numpy(a[k]) for k in ("ln_s", "ln_b", "wqkv", "bqkv",
                                         "wout", "bout")]
    bias = attn_bias(cfg["h"], cfg["w"], cfg["h0"], cfg["w0"], cfg["win"],
                     cfg["shift"], torch.device("cpu"))
    got = swin_attn.swin_window_attention(*targs, bias, **kw)
    assert got.dtype == tdt and got.shape == targs[0].shape
    got = got.float().numpy()
    tol = 1e-5 if dtype == "f32" else 3e-2
    for ref in (ref_kernel, ref_twin):
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("geom", [
    (8, 8, 8, 8, 4, 0), (8, 8, 8, 8, 4, 2), (8, 12, 7, 10, 4, 0),
    (8, 12, 7, 10, 4, 2), (16, 16, 16, 16, 4, 2), (14, 14, 14, 14, 7, 3),
    (64, 64, 64, 64, 8, 4), (32, 32, 28, 28, 8, 4), (8, 8, 8, 8, 8, 0),
    (4, 4, 3, 3, 2, 0), (6, 6, 5, 5, 3, 1),
])
def test_mask_builders_bit_equal(geom):
    want = jax_attn_mask(*geom)
    got = _attn_mask(*geom)
    if want is None:
        assert got is None
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    bias = attn_bias(*geom, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(bias, np.where(want, 0.0, -1e9)
                                  .astype(np.float32))


def test_wrapper_rejects_what_the_kernel_cannot_take():
    a = {k: torch.from_numpy(v) for k, v in
         _draws(b=1, h=8, w=8, c=16).items()}
    args = [a[k] for k in ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wout",
                           "bout")]
    with pytest.raises(ValueError, match="window"):   # 6 does not tile 8
        swin_attn.swin_window_attention(*args, None, win=6, heads=2)
    with pytest.raises(ValueError, match="head dim"):
        swin_attn.swin_window_attention(*args, None, win=4, heads=3)
    with pytest.raises(ValueError, match="bias"):
        swin_attn.swin_window_attention(
            *args, torch.zeros(3, 16, 16), win=4, heads=2)
    with pytest.raises(TypeError):
        swin_attn.swin_window_attention(
            args[0].half(), *args[1:], None, win=4, heads=2)
    before = swin_attn.launches
    swin_attn.swin_window_attention(*args, None, win=4, heads=2)
    assert swin_attn.launches == before   # the plain version is no launch

