"""Port band paths of the scene engine (streamed window path, fullconv
bands, device-resident fullconv and its block grid) and the predict
CLI's dispatch to them, against the JAX engine on carried weights.

The tiny SwinUNet of ``test_torch_swin_model`` (stride product 32) runs
at p 32 with border correction 64 (fullconv halo 16), f32 on both sides.
Tolerances: the streamed labels equal the port's own ``predict_scene`` on
every pixel (the same windows in the same batches of each band's window
path); port labels agree with the JAX package's on at least 99.9% of
pixels (both f32: a label differs only where two logits tie to within
summation-order noise; observed: every pixel equal in every case here).
A pointwise toy net with integer weights sums exactly in f32, so its
fullconv labels must equal one direct forward of the scene bit for bit,
at every banding and block grid.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.infer import InferenceConfig as JaxInferenceConfig
from cvcs_tpu.infer import SceneSegmenter as JaxSceneSegmenter
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import predict as predict_cli
from cvcs_tpu_torch.data.palette import PALETTE
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
from test_torch_engine import MIN_AGREEMENT, agreement, scene, weights  # noqa: F401
from test_torch_swin_model import NUM_CLASSES

P, BC, HALO = 32, 64, 16
STRIDE = 32                      # SwinUNet's stride product


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def segmenters(weights, **cfg):
    variables, jmodel, model = weights
    cfg = dict(patch_size=P, border_correction=BC, num_classes=NUM_CLASSES,
               **cfg)
    jseg = JaxSceneSegmenter(jmodel.apply, variables,
                             JaxInferenceConfig(**cfg),
                             stride_product=STRIDE)
    seg = SceneSegmenter(model, InferenceConfig(**cfg),
                         stride_product=STRIDE, device="cpu")
    return jseg, seg


@pytest.mark.parametrize("bug_parity", [False, True],
                         ids=["centered", "bug_parity"])
@pytest.mark.parametrize("band_rows", [1, 2, 3])
def test_streamed_equals_scene(weights, band_rows, bug_parity):
    jseg, seg = segmenters(weights, batch_tiles=5, bug_parity=bug_parity)
    sc = scene(seed=21)                       # 128 x 192: 4 x 6 tiles
    got = seg.predict_scene_streamed(sc, band_rows=band_rows)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, seg.predict_scene(sc).numpy())
    if band_rows == 2:   # equal-height bands: one JAX program to compile
        want = np.asarray(jseg.predict_scene_streamed(sc, band_rows=2))
        assert len(np.unique(want)) > 1
        assert agreement(got, want) >= MIN_AGREEMENT


def test_fullconv_paths_match_jax(weights):
    jseg, seg = segmenters(weights, batch_tiles=5)
    # partial tiles past the grid: real pixels in the bottom and right halo
    sc = scene(seed=22, h=5 * P, w=7 * P)[:4 * P + 5, :6 * P + 7]
    want = np.asarray(jseg.predict_scene_fullconv(sc, band_rows=2))
    got = seg.predict_scene_fullconv(sc, band_rows=2)
    assert got.dtype == np.uint8 and got.shape == (4 * P, 6 * P)
    assert len(np.unique(want)) > 1
    assert agreement(got, want) >= MIN_AGREEMENT

    padded, rows, cols, halo = seg.pad_scene_fullconv(sc)
    assert (rows, cols, halo) == (4, 6, HALO)
    dev = seg.predict_padded_fullconv(padded, rows, cols, halo, band_rows=2)
    np.testing.assert_array_equal(dev.numpy(), got)
    jpad, *_ = jseg.pad_scene_fullconv(sc)
    chunk = dict(band_rows=2, row_tiles=1, col_tiles=3)
    want_chunk = np.asarray(jseg.predict_padded_fullconv(
        jpad, rows, cols, halo, **chunk))
    got_chunk = seg.predict_padded_fullconv(padded, rows, cols, halo,
                                            **chunk)
    assert agreement(got_chunk.numpy(), want_chunk) >= MIN_AGREEMENT


class Pointwise(torch.nn.Module):
    """A 1x1 conv with small integer weights: f32 sums of uint8 pixels are
    exact, so its labels depend on nothing but the pixel."""

    def __init__(self, seed=0):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w = torch.randint(-3, 4, (NUM_CLASSES, 3), generator=g).float()

    def forward(self, x):                       # NHWC
        return torch.einsum("bhwc,kc->bhwk", x, self.w)


def test_fullconv_pointwise_equals_direct_forward():
    net = Pointwise()
    seg = SceneSegmenter(net, InferenceConfig(
        patch_size=P, border_correction=BC, num_classes=NUM_CLASSES),
        device="cpu")
    rng = np.random.default_rng(23)
    sc = rng.integers(0, 256, (3 * P + 5, 6 * P + 7, 3), np.uint8)
    with torch.inference_mode():
        direct = net(torch.from_numpy(sc).float()[None]).argmax(-1)[0]
    direct = direct.to(torch.uint8).numpy()[:3 * P, :6 * P]
    padded, rows, cols, halo = seg.pad_scene_fullconv(sc)
    for band_rows in (1, 2, 4, 8):
        out = seg.predict_scene_fullconv(sc, band_rows=band_rows)
        np.testing.assert_array_equal(out, direct)
        dev = seg.predict_padded_fullconv(padded, rows, cols, halo,
                                          band_rows=band_rows)
        np.testing.assert_array_equal(dev.numpy(), direct)
        for col_tiles, row_tiles in ((1, None), (3, None), (2, 2)):
            chk = seg.predict_padded_fullconv(
                padded, rows, cols, halo, band_rows=band_rows,
                col_tiles=col_tiles, row_tiles=row_tiles)
            np.testing.assert_array_equal(chk.numpy(), direct)


def test_fullconv_errors_as_jax():
    def refuse(seg, call):
        with pytest.raises(ValueError) as e:
            call(seg)
        return str(e.value)

    cfg = dict(patch_size=P, border_correction=P + 20, batch_tiles=2,
               num_classes=NUM_CLASSES)      # halo 10: bands of 84 rows
    seg = SceneSegmenter(Pointwise(), InferenceConfig(**cfg),
                         stride_product=STRIDE, device="cpu")
    jseg = JaxSceneSegmenter(lambda *a, **k: None, {},
                             JaxInferenceConfig(**cfg),
                             stride_product=STRIDE)
    sc = np.zeros((2 * P, 6 * P, 3), np.uint8)
    msg = refuse(seg, lambda s: s.predict_scene_fullconv(sc, band_rows=2))
    assert "stride product 32" in msg and "fullconv_bands" in msg
    assert msg == refuse(jseg,
                         lambda s: s.predict_scene_fullconv(sc, band_rows=2))
    padded, rows, cols, halo = seg.pad_scene_fullconv(sc)
    assert "stride product" in refuse(
        seg, lambda s: s.predict_padded_fullconv(padded, rows, cols, halo,
                                                 band_rows=2))
    for bad in (0, 4):                         # 6 tile columns
        msg = refuse(seg, lambda s: s.predict_padded_fullconv(
            padded, rows, cols, halo, col_tiles=bad))
        assert f"col_tiles={bad}" in msg
    tta = SceneSegmenter(Pointwise(), InferenceConfig(**cfg, tta=True),
                         device="cpu")
    jtta = JaxSceneSegmenter(lambda *a, **k: None, {},
                             JaxInferenceConfig(**cfg, tta=True))
    for call in (lambda s: s.predict_scene_fullconv(sc),
                 lambda s: s.pad_scene_fullconv(sc)):
        msg = refuse(tta, call)
        assert "fullconv" in msg and msg == refuse(jtta, call)


@pytest.mark.parametrize("extra", [
    dict(stream_rows=2), dict(fullconv_bands=2),
    dict(fullconv_bands=2, fullconv_chunks=[1, 2]),
], ids=["stream_rows", "fullconv_bands", "fullconv_chunks"])
def test_predict_cli_dispatch(gid15_root, tmp_path, extra):
    out = tmp_path / "out"
    config = dict(dataset=str(gid15_root), net="SwinUnetTiny", patch_size=P,
                  border_correction=BC, num_classes=15, precision="f32",
                  device="cpu", mask_only=True, range=[0, 24],
                  output=str(out), out_image=str(tmp_path / "map.png"),
                  **extra)
    predict_cli.predict(dict(config))
    model, spec, _ = common.build_apply(config, torch.device("cpu"))
    seg = SceneSegmenter(model, InferenceConfig(
        patch_size=P, border_correction=BC, num_classes=16),
        stride_product=spec.stride_product, device="cpu")
    raw = np.asarray(Image.open(sorted(
        (gid15_root / "Image__8bit_NirRGB").glob("*.png"))[1]))
    if "stream_rows" in extra:
        want = seg.predict_scene_streamed(raw, band_rows=2)
    elif "fullconv_chunks" in extra:
        padded, rows, cols, halo = seg.pad_scene_fullconv(raw)
        want = seg.predict_padded_fullconv(padded, rows, cols, halo,
                                           band_rows=2, row_tiles=1,
                                           col_tiles=2).numpy()
    else:
        want = seg.predict_scene_fullconv(raw, band_rows=2)
    # 96 x 128 scenes at p 32: 12 tiles each; range [0, 24) = scenes 0, 1
    assert sorted(int(f.stem) for f in out.glob("*.png")) == list(range(24))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "map_1.png")), PALETTE[want])
    np.testing.assert_array_equal(np.asarray(Image.open(out / "13.png")),
                                  PALETTE[want[:P, P:2 * P]])


def test_predict_cli_mesh_still_raises(gid15_root, tmp_path):
    config = dict(dataset=str(gid15_root), net="SwinUnetTiny", patch_size=P,
                  device="cpu", output=str(tmp_path),
                  mesh={"spatial": 2}, fullconv_bands=2)
    with pytest.raises(NotImplementedError, match="item 14"):
        predict_cli.predict(config)
