"""The Swin window-attention CUDA kernel against its plain version, on the
card. Marked ``cuda``: on a machine without a card every test skips.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_swin_attn_cuda.py

Shapes are the main path's four stage shapes (p 224, border correction
256) at a batch of 4 windows, unmasked and with the shifted-window mask,
plus win 7 (T = 49) and a pad-masked map (56 -> 64); and the edges of
the kernels' tiling (``EDGES``: a GEMM tile of 64 tokens x 96 columns,
head dims padded to 16, 16-byte chunks): C below or off the tile (32, 48,
and 36, whose rows are no whole number of chunks), a token count off the
row tile (7 x 7 maps at batch 3), T = 49, a pad-masked 56 -> 64 map, and
head dims 12, 16 and 64. Tolerances: f32 1e-5 * max(1, |plain|max) (both
in f32, only the summation order differs); bf16 3e-2 * scale (a rounding
point may flip one bf16 ulp).
"""

import pytest
import torch

from cvcs_tpu_torch.models.swin import attn_bias
from cvcs_tpu_torch.ops import swin_attn

pytestmark = pytest.mark.cuda

# (Hp = Wp, C, heads, win, h0 = w0, shift)
SHAPES = {
    "s1": (64, 96, 3, 8, 64, 0), "s1_shift": (64, 96, 3, 8, 64, 4),
    "s2": (32, 192, 6, 8, 32, 0), "s2_shift": (32, 192, 6, 8, 32, 4),
    "s3": (16, 384, 12, 8, 16, 0), "s3_shift": (16, 384, 12, 8, 16, 4),
    "s4": (8, 768, 24, 8, 8, 0), "t49": (7, 768, 24, 7, 7, 0),
    "pad56": (64, 96, 3, 8, 56, 0), "win4_shift": (16, 64, 2, 4, 14, 2),
}
# (Hp = Wp, C, heads, win, h0 = w0, shift, batch)
EDGES = {
    "tiny_c32": (56, 32, 1, 8, 56, 0, 2),       # SwinUnetTiny stage 1
    "c48_h3": (16, 48, 3, 8, 14, 4, 2),         # d 16, C off the tile
    "c36_h3": (8, 36, 3, 4, 6, 2, 2),           # d 12, rows not in chunks
    "n147_t49": (7, 96, 3, 7, 7, 0, 3),         # N = 147, T = 49
    "pad56": (64, 96, 3, 8, 56, 4, 1),          # pad-masked and shifted
    "d64": (16, 128, 2, 8, 14, 4, 2),           # head dim 64
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, device, b=4, seed=0):
    hp, c, heads, win, h0, shift = shape
    g = torch.Generator().manual_seed(seed)

    def rnd(*s, std=1.0):
        return (torch.randn(s, generator=g) * std).to(device)

    args = [rnd(b, hp, hp, c).to(dtype), 1 + rnd(c, std=0.1),
            rnd(c, std=0.1), rnd(c, 3 * c, std=c ** -0.5),
            rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, hp, h0, h0, win, shift, device)
    return args, bias, dict(win=win, heads=heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain(card, name, dtype):
    args, bias, kw = _inputs(SHAPES[name], dtype, card)
    before = swin_attn.launches
    got = swin_attn.swin_window_attention(*args, bias, **kw)
    torch.cuda.synchronize()
    assert swin_attn.launches == before + 1
    want = swin_attn.swin_window_attention_plain(*args, bias, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(EDGES))
def test_kernel_matches_plain_at_tile_edges(card, name, dtype):
    *shape, b = EDGES[name]
    args, bias, kw = _inputs(shape, dtype, card, b=b)
    before = swin_attn.launches
    got = swin_attn.swin_window_attention(*args, bias, **kw)
    torch.cuda.synchronize()
    assert swin_attn.launches == before + 1
    want = swin_attn.swin_window_attention_plain(*args, bias, **kw)
    assert got.dtype == dtype and got.shape == want.shape
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype] * scale, err
    again = swin_attn.swin_window_attention(*args, bias, **kw)
    assert torch.equal(got, again)


def test_kernel_is_deterministic(card):
    args, bias, kw = _inputs(SHAPES["s3_shift"], torch.bfloat16, card)
    a = swin_attn.swin_window_attention(*args, bias, **kw)
    b = swin_attn.swin_window_attention(*args, bias, **kw)
    assert torch.equal(a, b)


def test_kernel_raises_where_it_cannot_run(card):
    """Shapes past the kernel's limits raise on the card; nothing falls
    back to the plain version."""
    args, _, _ = _inputs((18, 128, 1, 9, 18, 0), torch.float32, card, b=1)
    before = swin_attn.launches
    with pytest.raises(ValueError, match="64 tokens"):     # T = 81
        swin_attn.swin_window_attention(*args, None, win=9, heads=1)
    with pytest.raises(ValueError, match="head dim"):      # d = 128
        swin_attn.swin_window_attention(*args, None, win=6, heads=1)
    with pytest.raises(TypeError):
        swin_attn.swin_window_attention(args[0].half(), *args[1:], None,
                                        win=6, heads=2)
    assert swin_attn.launches == before
