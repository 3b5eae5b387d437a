"""Port whole-scene window engine vs the JAX engine, on carried weights.

A synthetic 128 x 192 scene (p 32 -> 4 x 6 tiles) goes through the JAX
``SceneSegmenter`` (SwinUNet under the f32 policy) and the port's, whose
model carries the same variables. The label maps must agree on at least
99.9% of pixels: both run in f32, so a label differs only where two
logits tie to within summation-order noise (observed: 0 of 24,576
pixels differ in every configuration here).
"""

import jax
import numpy as np
import pytest
import torch

from cvcs_tpu.infer import InferenceConfig as JaxInferenceConfig
from cvcs_tpu.infer import SceneSegmenter as JaxSceneSegmenter
from cvcs_tpu.models.swin import SwinUNet as JaxSwinUNet
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
from test_torch_swin_model import NUM_CLASSES, TINY, jax_variables, port_model

P = 32
MIN_AGREEMENT = 0.999


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it
    (observed: the train CLI test took 375 s under six workers, 10 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(seed=0, h=128, w=192):
    """Blocky synthetic scene: spatial structure, so labels vary."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
    noise = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
    return np.kron(base, np.ones((8, 8, 1), np.uint8)) // 2 + noise


@pytest.fixture(scope="module")
def weights():
    variables = jax_variables(bands=3, seed=1)
    jmodel = JaxSwinUNet(num_classes=NUM_CLASSES, dtype=jax.numpy.float32,
                         **TINY)
    return variables, jmodel, port_model(variables, bands=3)


def segmenters(weights, **cfg):
    variables, jmodel, model = weights
    jseg = JaxSceneSegmenter(jmodel.apply, variables, JaxInferenceConfig(
        patch_size=P, num_classes=NUM_CLASSES, **cfg))
    seg = SceneSegmenter(model, InferenceConfig(
        patch_size=P, num_classes=NUM_CLASSES, **cfg), device="cpu")
    return jseg, seg


def agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float((a == b).mean())


@pytest.mark.parametrize("cfg", [
    dict(border_correction=None, batch_tiles=5),
    dict(border_correction=64, batch_tiles=7, tta=True),
    dict(border_correction=64, batch_tiles=24, bug_parity=True),
], ids=["bc_none", "bc64_tta", "bc64_bug_parity"])
def test_scene_labels_match_jax(weights, cfg):
    jseg, seg = segmenters(weights, **cfg)
    sc = scene(seed=3)
    want = np.asarray(jseg.predict_scene(sc))
    got = seg.predict_scene(sc)
    assert got.dtype == torch.uint8 and got.shape == (128, 192)
    assert len(np.unique(want)) > 1          # not a vacuous comparison
    assert agreement(got.numpy(), want) >= MIN_AGREEMENT


def test_scenes_and_tiles_match_scene(weights):
    _, seg = segmenters(weights, border_correction=64, batch_tiles=5)
    scenes = [scene(seed=s, h=96, w=128) for s in (4, 5, 6)]
    single = np.stack([seg.predict_scene(s).numpy() for s in scenes])
    batched = seg.predict_scenes(scenes).numpy()
    np.testing.assert_array_equal(batched, single)
    cols = 128 // P
    ids = [0, 1, cols, 3 * cols - 1]
    tiles = seg.predict_tiles(scenes[1], ids).numpy()
    assert tiles.shape == (len(ids), P, P)
    for k, i in enumerate(ids):
        r, c = divmod(i, cols)
        np.testing.assert_array_equal(
            tiles[k], single[1, r * P:(r + 1) * P, c * P:(c + 1) * P])
    assert seg.predict_tiles(scenes[0], []).shape == (0, P, P)


def test_engine_guards(weights):
    _, _, model = weights
    with pytest.raises(ValueError, match="border_correction"):
        SceneSegmenter(model, InferenceConfig(patch_size=P,
                                              border_correction=P - 2),
                       device="cpu")
    with pytest.raises(ValueError, match="context"):
        SceneSegmenter(model, InferenceConfig(patch_size=P), device="cpu",
                       requires_context=True)
    seg = SceneSegmenter(model, InferenceConfig(patch_size=P), device="cpu")
    with pytest.raises(ValueError, match="smaller than one"):
        seg.predict_scene(np.zeros((P - 1, 2 * P, 3), np.uint8))
