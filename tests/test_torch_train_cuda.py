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
and the flip propagates through the products.

K5 against its plain version run on the card, at bands C 1-4, patch
sizes P 224, 97 (rows not 16-byte aligned), 256 and 512 (staged in two
pieces a band), batches 1, 3 and 160, with every one of the 16 (flip,
rot90) draws: all elements equal for P <= 256 (the grayscale sum of
integers below 2^24 is exact on both sides, and both take the mean as
the sum times the f32 reciprocal of P*P); for P = 512 (sums above 2^24,
which torch rounds in its own order) at least 99.9% equal and the rest
within 1/std. Also a source 1 byte past a 16-byte boundary, 13 and 17
bands, patches too wide for 32-bit indices (P 3100, not staged; P 2048,
staged in pieces), and the launch plan the kernel computes against
``band_plan``.
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


def _k5_case(card, b, p, c, seed, shift=0):
    g = torch.Generator(device=card).manual_seed(seed)
    img = torch.randint(0, 256, (b, p, p, c), generator=g, device=card,
                        dtype=torch.uint8)
    _, _, factors = augment.draw_dihedral(b, 0.6, g)
    draw = (torch.arange(b, device=card) + shift) % 16
    flips, rots = (draw // 4).to(torch.int32), (draw % 4).to(torch.int32)
    mean = torch.linspace(60.0, 120.0, c, device=card)
    std = torch.linspace(30.0, 70.0, c, device=card)
    return img, flips, rots, factors, mean, std


def _assert_k5(got, want, std, exact):
    assert got.shape == want.shape and got.dtype == torch.float32
    differ = int((got != want).sum())     # a count: an f32 mean would round
    equal = 1 - differ / got.numel()
    if exact:
        assert differ == 0, differ
    else:
        assert equal >= 0.999, equal
        assert ((got - want).abs() <= 1.0 / std + 1e-6).all()


@pytest.mark.parametrize("b", [1, 3, 160])
@pytest.mark.parametrize("p", [224, 97, 256, 512])
@pytest.mark.parametrize("c", [1, 2, 3, 4])
def test_augment_kernel_matches_plain(card, c, p, b):
    for shift in range(0, 16, b):       # every (flip, rot90) draw
        args = _k5_case(card, b, p, c, seed=1000 * c + p + shift, shift=shift)
        before = augment.launches
        got = augment.fused_augment(*args)
        torch.cuda.synchronize()
        assert augment.launches == before + 1
        want = augment.fused_augment_plain(*args)
        _assert_k5(got, want, args[5], exact=p <= 256)


@pytest.mark.parametrize("p, c", [(224, 3), (97, 3), (33, 4)])
def test_augment_kernel_unaligned_source(card, p, c):
    img, *rest = _k5_case(card, 16, p, c, seed=p + c)
    shifted = torch.empty(img.numel() + 1, dtype=torch.uint8,
                          device=card)[1:].view(img.shape)
    shifted.copy_(img)
    assert shifted.data_ptr() % 16
    got = augment.fused_augment(shifted, *rest)
    torch.cuda.synchronize()
    _assert_k5(got, augment.fused_augment_plain(img, *rest), rest[4],
               exact=True)


@pytest.mark.parametrize("p, c, staged", [(3100, 1, False), (2048, 3, True)])
def test_augment_kernel_wide(card, p, c, staged):
    """Patches with P^3 >= 2^32 (the kernel's 64-bit index instance):
    P 3100, where one row's column band does not fit the staging budget
    and the kernel reads its source bytes from device memory, and P 2048,
    each band staged in pieces."""
    plan = augment.band_plan(p, c)
    assert (plan["stage_rows"] > 0) == staged
    assert plan["stage_rows"] < plan["band_rows"]
    for shift in (0, 5, 10, 15):
        args = _k5_case(card, 1, p, c, seed=shift, shift=shift)
        got = augment.fused_augment(*args)
        torch.cuda.synchronize()
        _assert_k5(got, augment.fused_augment_plain(*args), args[5],
                   exact=False)


@pytest.mark.parametrize("c", [13, 17])
def test_augment_kernel_many_bands(card, c):
    """13 bands take the per-band output table; 17 the blend table and a
    divide per element."""
    args = _k5_case(card, 16, 33, c, seed=c)
    got = augment.fused_augment(*args)
    torch.cuda.synchronize()
    _assert_k5(got, augment.fused_augment_plain(*args), args[5], exact=True)


def test_augment_plan_matches_kernel(card):
    for p in (1, 2, 5, 7, 8, 9, 33, 97, 224, 256, 512, 513, 2048, 3100, 8192):
        for c in (1, 2, 3, 4, 13, 17):
            assert augment.kernel_plan(p, c) == augment.band_plan(p, c), (p, c)
