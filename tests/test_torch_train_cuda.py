"""The training slice's CUDA kernels against their plain versions, on the
card: the Swin window-attention backward (K2) and the fused augmentation
(K5). Marked ``cuda``: on a machine without a card every test skips.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_train_cuda.py

K2 shapes are the four SwinUnet stage shapes of a p-224 training step
(stage 1 56 x 56 unpadded, stage 2 28 -> 32 and stage 3 14 -> 16 padded,
stage 4 a single 7 x 7 window, T = 49), shifted and unshifted, at a batch
of 2, plus a pad-masked 56 -> 64 map; and the edges of the kernels'
tiling (``EDGES``, as in ``tests/test_torch_swin_attn_cuda.py``): C 32,
48 and 36, 7 x 7 maps at batch 3 (T = 49), a pad-masked shifted map,
head dims 12, 16 and 64. Tolerances on all seven outputs:
f32 1e-4 * max(1, |plain|max) (both in f32, only summation orders
differ); bf16 5e-2 * scale, as the JAX package's own backward test
(``tests/test_pallas_swin.py``): a rounding point may flip one bf16 ulp
and the flip propagates through the products. K5: equal elements except
near floor boundaries (at least 99.9% equal, the rest within 1/std).
"""

import pytest
import torch

from cvcs_tpu_torch.models.swin import attn_bias
from cvcs_tpu_torch.ops import augment, swin_attn

pytestmark = pytest.mark.cuda

# (Hp = Wp, C, heads, win, h0 = w0, shift)
SHAPES = {
    "s1": (56, 96, 3, 8, 56, 0), "s1_shift": (56, 96, 3, 8, 56, 4),
    "s2": (32, 192, 6, 8, 28, 0), "s2_shift": (32, 192, 6, 8, 28, 4),
    "s3": (16, 384, 12, 8, 14, 0), "s3_shift": (16, 384, 12, 8, 14, 4),
    "s4": (7, 768, 24, 7, 7, 0), "pad56": (64, 96, 3, 8, 56, 0),
}
# (Hp = Wp, C, heads, win, h0 = w0, shift, batch)
EDGES = {
    "tiny_c32": (56, 32, 1, 8, 56, 0, 2),
    "c48_h3": (16, 48, 3, 8, 14, 4, 2),
    "c36_h3": (8, 36, 3, 4, 6, 2, 2),
    "n147_t49": (7, 96, 3, 7, 7, 0, 3),
    "pad56": (64, 96, 3, 8, 56, 4, 1),
    "d64": (16, 128, 2, 8, 14, 4, 2),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
GRADS = ("dx", "dlns", "dlnb", "dwqkv", "dbqkv", "dwout", "dbout")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, b=2, seed=0):
    hp, c, heads, win, h0, shift = shape
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=g) * std).to(device)

    args = [rnd(b, hp, hp, c).to(dtype), 1 + rnd(c, std=0.1),
            rnd(c, std=0.1), rnd(c, 3 * c, std=c ** -0.5),
            rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, hp, h0, h0, win, shift, device)
    cot = rnd(b, hp, hp, c).to(dtype)
    return args, bias, cot, dict(win=win, heads=heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_bwd_kernel_matches_plain(card, name, dtype):
    args, bias, cot, kw = _inputs(SHAPES[name], dtype, card)
    before = swin_attn.bwd_launches
    got = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    torch.cuda.synchronize()
    assert swin_attn.bwd_launches == before + 1
    want = swin_attn.swin_window_attention_bwd_plain(*args, bias, cot, **kw)
    for n, a, w in zip(GRADS, got, want):
        assert a.shape == w.shape and a.dtype == w.dtype, n
        scale = max(1.0, w.float().abs().max().item())
        err = (a.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype] * scale, (n, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(EDGES))
def test_bwd_kernel_matches_plain_at_tile_edges(card, name, dtype):
    *shape, b = EDGES[name]
    args, bias, cot, kw = _inputs(shape, dtype, card, b=b)
    before = swin_attn.bwd_launches
    got = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    torch.cuda.synchronize()
    assert swin_attn.bwd_launches == before + 1
    want = swin_attn.swin_window_attention_bwd_plain(*args, bias, cot, **kw)
    again = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    for n, a, w, r in zip(GRADS, got, want, again):
        assert a.shape == w.shape and a.dtype == w.dtype, n
        scale = max(1.0, w.float().abs().max().item())
        err = (a.float() - w.float()).abs().max().item()
        assert err <= TOL[dtype] * scale, (n, err, scale)
        assert torch.equal(a, r), n


def test_autograd_runs_both_kernels(card):
    """Through the autograd op, a CUDA tensor launches K1 forward and K2
    backward once each, and the f32 parameter grads equal the direct
    launch's."""
    args, bias, cot, kw = _inputs(SHAPES["s2_shift"], torch.bfloat16, card)
    leaves = [a.detach().clone().requires_grad_() for a in args]
    f0, b0 = swin_attn.launches, swin_attn.bwd_launches
    out = swin_attn.swin_window_attention(*leaves, bias, **kw)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (swin_attn.launches, swin_attn.bwd_launches) == (f0 + 1, b0 + 1)
    direct = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    for n, leaf, want in zip(GRADS, leaves, direct):
        assert leaf.grad.dtype == leaf.dtype, n
        assert torch.equal(leaf.grad, want.to(leaf.dtype)), n


def test_bwd_kernel_is_deterministic(card):
    args, bias, cot, kw = _inputs(SHAPES["s1_shift"], torch.bfloat16, card)
    a = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    b = swin_attn._bwd_kernel_launch(*args, bias, cot, **kw)
    for n, x, y in zip(GRADS, a, b):
        assert torch.equal(x, y), n


def test_kernels_raise_where_they_cannot_run(card):
    """Shapes past the kernels' limits raise on the card; nothing falls
    back to a plain version."""
    args, _, _, _ = _inputs((18, 128, 1, 9, 18, 0), torch.float32, card, b=1)
    leaves = [a.requires_grad_() for a in args]
    counts = (swin_attn.launches, swin_attn.bwd_launches)
    with pytest.raises(ValueError, match="64 tokens"):     # T = 81
        swin_attn.swin_window_attention(*leaves, None, win=9, heads=1)
    with pytest.raises(ValueError, match="head dim"):      # d = 128
        swin_attn.swin_window_attention(*leaves, None, win=6, heads=1)
    with pytest.raises(TypeError):
        swin_attn.swin_window_attention(args[0].half(), *leaves[1:], None,
                                        win=6, heads=2)
    assert (swin_attn.launches, swin_attn.bwd_launches) == counts
    img = torch.zeros(2, 8, 8, 3, dtype=torch.uint8, device=card)
    ones = torch.ones(3, device=card)
    zeros2 = torch.zeros(2, device=card)
    before = augment.launches
    with pytest.raises(TypeError):
        augment.fused_augment(img.float(), zeros2, zeros2, zeros2, ones, ones)
    with pytest.raises(ValueError, match="images must be"):
        augment.fused_augment(img[:, :4], zeros2, zeros2, zeros2, ones, ones)
    assert augment.launches == before


@pytest.mark.parametrize("c", [3, 4])
def test_augment_kernel_matches_plain(card, c):
    g = torch.Generator(device=card).manual_seed(c)
    b, p = 16, 224
    img = torch.randint(0, 256, (b, p, p, c), generator=g, device=card,
                        dtype=torch.uint8)
    flips, rots, factors = augment.draw_dihedral(b, 0.6, g)
    mean = torch.linspace(60.0, 120.0, c, device=card)
    std = torch.linspace(30.0, 70.0, c, device=card)
    before = augment.launches
    got = augment.fused_augment(img, flips, rots, factors, mean, std)
    torch.cuda.synchronize()
    assert augment.launches == before + 1
    want = augment.fused_augment_plain(img, flips, rots, factors, mean, std)
    assert got.shape == want.shape == (b, p, p, c)
    assert got.dtype == torch.float32
    equal = (got == want).float().mean().item()
    assert equal >= 0.999, equal
    assert ((got - want).abs() <= 1.0 / std + 1e-6).all()
