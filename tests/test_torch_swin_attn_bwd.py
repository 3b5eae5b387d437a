"""Port's Swin window-attention backward (the plain K2, as the autograd
op runs it on CPU tensors) vs the JAX package's backward.

The same numpy draws go to both: JAX's Pallas backward ``_bwd_pallas`` in
interpret mode and ``jax.vjp`` of its jnp twin ``_reference_fused``, and
the port's ``swin_window_attention`` through autograd
(``SwinWindowAttentionFn``) with f32 parameters. Every mask regime of
``tests/test_torch_swin_attn.py`` is covered (maskless, region, pad,
combined, single window, win 7 / T = 49), and all seven gradients (dx and
the six parameter grads) are compared.

Tolerances: f32 1e-4 * max(1, |ref|max) (both sides in f32, only
summation orders differ); bf16 5e-2 * scale, as the JAX package's own
backward test: a rounding point may flip one bf16 ulp and the flip
propagates through the products. The plain backward is also held against
torch autograd through the plain forward in f32 (1e-5 * scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models.swin import _attn_mask as jax_attn_mask
from cvcs_tpu.ops.pallas_swin import _bwd_pallas, _reference_fused
from cvcs_tpu_torch.models.swin import attn_bias
from cvcs_tpu_torch.ops import swin_attn

# the mask regimes of tests/test_torch_swin_attn.py, at batch 1 (the
# interpret-mode kernel unrolls its loops over the batch)
CASES = {
    "maskless": dict(b=1, h=8, w=8, h0=8, w0=8, c=16, heads=2, win=4, shift=0),
    "region": dict(b=1, h=8, w=12, h0=8, w0=12, c=16, heads=2, win=4, shift=2),
    "pad": dict(b=1, h=8, w=12, h0=7, w0=10, c=16, heads=2, win=4, shift=0),
    "combined": dict(b=1, h=8, w=12, h0=7, w0=10, c=16, heads=4, win=4,
                     shift=2),
    "single_window": dict(b=2, h=4, w=4, h0=4, w0=4, c=16, heads=2, win=4,
                          shift=0),
    "win7_t49": dict(b=1, h=14, w=14, h0=14, w0=14, c=32, heads=2, win=7,
                     shift=3),
}
NAMES = ("x", "ln_s", "ln_b", "wqkv", "bqkv", "wout", "bout")


def _draws(b, h, w, c, seed=0, **_):
    rng = np.random.default_rng(seed)
    out = dict(
        x=rng.standard_normal((b, h, w, c)).astype(np.float32),
        ln_s=rng.standard_normal(c).astype(np.float32),
        ln_b=rng.standard_normal(c).astype(np.float32),
        wqkv=(rng.standard_normal((c, 3 * c)) * 0.1).astype(np.float32),
        bqkv=(rng.standard_normal(3 * c) * 0.1).astype(np.float32),
        wout=(rng.standard_normal((c, c)) * 0.1).astype(np.float32),
        bout=(rng.standard_normal(c) * 0.1).astype(np.float32))
    out["g"] = rng.standard_normal((b, h, w, c)).astype(np.float32)
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backward_matches_jax(case, dtype):
    cfg = CASES[case]
    a = _draws(**cfg)
    kw = dict(win=cfg["win"], heads=cfg["heads"])
    mask = jax_attn_mask(cfg["h"], cfg["w"], cfg["h0"], cfg["w0"],
                         cfg["win"], cfg["shift"])
    jbias = (None if mask is None else
             jnp.asarray(np.where(mask, 0.0, -1e9).astype(np.float32)))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16

    jargs = [jnp.asarray(a["x"], jdt)] + [jnp.asarray(a[k]) for k in NAMES[1:]]
    g = jnp.asarray(a["g"], jdt)
    ref_kernel = _bwd_pallas(*jargs, jbias, g, interpret=True, **kw)
    ref_twin = jax.jit(lambda *p: jax.vjp(
        lambda *q: _reference_fused(*q, jbias, **kw), *p)[1](g))(*jargs)

    leaves = ([torch.from_numpy(a["x"]).to(tdt).requires_grad_()]
              + [torch.from_numpy(a[k]).requires_grad_() for k in NAMES[1:]])
    bias = attn_bias(cfg["h"], cfg["w"], cfg["h0"], cfg["w0"], cfg["win"],
                     cfg["shift"], torch.device("cpu"))
    before = swin_attn.bwd_launches
    out = swin_attn.swin_window_attention(*leaves, bias, **kw)
    out.backward(torch.from_numpy(a["g"]).to(tdt))
    assert swin_attn.bwd_launches == before      # the plain version: no launch
    got = [leaf.grad for leaf in leaves]
    assert got[0].dtype == tdt
    assert all(gr.dtype == torch.float32 for gr in got[1:])
    tol = 1e-4 if dtype == "f32" else 5e-2
    for ref in (ref_kernel, ref_twin):
        for name, mine, want in zip(NAMES, got, ref):
            want = np.asarray(want, np.float32)
            assert mine.shape == want.shape, name
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(mine.float().numpy(), want, rtol=0,
                                       atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_is_autograd_of_plain_forward(case):
    """In f32 the casting points are identities, so the plain backward is
    the exact derivative of the plain forward."""
    cfg = CASES[case]
    a = {k: torch.from_numpy(v) for k, v in _draws(**cfg, seed=3).items()}
    kw = dict(win=cfg["win"], heads=cfg["heads"])
    bias = attn_bias(cfg["h"], cfg["w"], cfg["h0"], cfg["w0"], cfg["win"],
                     cfg["shift"], torch.device("cpu"))
    leaves = [a[k].clone().requires_grad_() for k in NAMES]
    swin_attn.swin_window_attention_plain(*leaves, bias, **kw).backward(a["g"])
    got = swin_attn.swin_window_attention_bwd_plain(
        *[a[k] for k in NAMES], bias, a["g"], **kw)
    for name, leaf, mine in zip(NAMES, leaves, got):
        want = leaf.grad
        scale = max(1.0, want.abs().max().item())
        assert (mine - want).abs().max().item() <= 1e-5 * scale, name
