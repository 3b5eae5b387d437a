"""The Swin window-attention kernel (K1) at the stage shapes of a
fullconv band, and the band paths of the scene engine, on the card.
Marked ``cuda``: on a machine without a card every test skips.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_stream_cuda.py

K1 shapes: the four stage maps of one 1824 x 7200 band (8 tile rows at p
224 plus a halo of 16) at batch 1, unshifted and shifted, from stage 2
on with the pad mask (non-square maps, 12,825 windows at stage 1), and
one chunked block batch (16 blocks of 480 x 1824, stage 2, shifted, one
mask shared by the batch). Tolerances as ``test_torch_swin_attn_cuda``:
f32 1e-5 * max(1, |plain|max), bf16 3e-2 * scale; repeats bit-equal.
The engine: the streamed labels equal ``predict_scene``'s and the
device-resident fullconv labels equal the banded ones, bit for bit
(the same forwards on the same inputs).
"""

import numpy as np
import pytest
import torch

from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.models.swin import attn_bias
from cvcs_tpu_torch.ops import swin_attn

pytestmark = pytest.mark.cuda

# (Hp, Wp, C, heads, win, h0, w0, shift, batch)
SHAPES = {
    "b1": (456, 1800, 96, 3, 8, 456, 1800, 0, 1),
    "b1_shift": (456, 1800, 96, 3, 8, 456, 1800, 4, 1),
    "b2": (232, 904, 192, 6, 8, 228, 900, 0, 1),
    "b2_shift": (232, 904, 192, 6, 8, 228, 900, 4, 1),
    "b3": (120, 456, 384, 12, 8, 114, 450, 0, 1),
    "b3_shift": (120, 456, 384, 12, 8, 114, 450, 4, 1),
    "b4": (64, 232, 768, 24, 8, 57, 225, 0, 1),
    "b4_shift": (64, 232, 768, 24, 8, 57, 225, 4, 1),
    "chunk_b16": (64, 232, 192, 6, 8, 60, 228, 4, 16),
}
TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_at_band_shapes(card, name, dtype):
    hp, wp, c, heads, win, h0, w0, shift, b = SHAPES[name]
    g = torch.Generator(device=card).manual_seed(0)

    def rnd(*s, std=1.0):
        return torch.randn(s, generator=g, device=card) * std

    args = [rnd(b, hp, wp, c).to(dtype), 1 + rnd(c, std=0.1),
            rnd(c, std=0.1), rnd(c, 3 * c, std=c ** -0.5),
            rnd(3 * c, std=0.02), rnd(c, c, std=c ** -0.5), rnd(c, std=0.02)]
    bias = attn_bias(hp, wp, h0, w0, win, shift, card)
    assert (bias is None) == (shift == 0 and (h0, w0) == (hp, wp))
    kw = dict(win=win, heads=heads)
    got = swin_attn.swin_window_attention(*args, bias, **kw)
    again = swin_attn.swin_window_attention(*args, bias, **kw)
    want = swin_attn.swin_window_attention_plain(*args, bias, **kw)
    torch.cuda.synchronize()
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= TOL[dtype] * scale, err
    assert torch.equal(got, again)


@pytest.fixture
def tiny_seg(card):
    model, spec = build_model("SwinUnetTiny", 16, seed=0,
                              dtype=torch.float32)
    return SceneSegmenter(model, InferenceConfig(
        patch_size=32, border_correction=64, batch_tiles=6, num_classes=16),
        stride_product=spec.stride_product)


def test_band_paths_on_card(tiny_seg):
    rng = np.random.default_rng(0)
    scene = rng.integers(0, 256, (4 * 32 + 5, 6 * 32 + 7, 3), np.uint8)
    window = tiny_seg.predict_scene(scene).cpu().numpy()
    for band_rows in (1, 3):
        np.testing.assert_array_equal(
            tiny_seg.predict_scene_streamed(scene, band_rows=band_rows),
            window)
    banded = tiny_seg.predict_scene_fullconv(scene, band_rows=2)
    padded, rows, cols, halo = tiny_seg.pad_scene_fullconv(scene)
    dev = tiny_seg.predict_padded_fullconv(padded, rows, cols, halo,
                                           band_rows=2)
    assert dev.is_cuda and dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.cpu().numpy(), banded)
