"""Port ESA entry point (``cvcs_tpu_torch.cli.esa``) on the CPU.

A raster that is not tile-aligned, (2p + 7) x (3p + 3), goes through
``esa.run`` with the registry's SwinUnetTiny (seeded weights, f32,
``device: cpu``, no border correction). The stitched map must be the
whole tiles' (2p, 3p, 3) and equal, pixel for pixel, the palette of the
labels of the port's engine for the same weights; a list of same-shape
rasters (the batched multi-scene pass) must give each raster its own.
Config validation as in the JAX package's CLI tests: a missing ``image``
raises ``KeyError``, an unknown key warns; a ``mesh`` over more ranks
than the one process raises ``MeshConfig.resolve``'s ``ValueError``.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import esa as esa_cli
from cvcs_tpu_torch.data.palette import PALETTE
from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

P = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def raster(tmp_path, name, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (10, 14, 3), np.uint8)
    img = np.kron(base, np.ones((8, 8, 1), np.uint8))[:2 * P + 7, :3 * P + 3]
    img = img // 2 + rng.integers(0, 64, img.shape, np.uint8)
    path = tmp_path / name
    Image.fromarray(img).save(path)
    return path, img


def config(tmp_path, image, **extra):
    return dict(image=image, net="SwinUnetTiny", patch_size=P,
                num_classes=15, precision="f32", device="cpu",
                out_image=str(tmp_path / "esa.png"), **extra)


def engine_labels(cfg, img):
    model, spec, num_classes = common.build_apply(cfg, torch.device("cpu"))
    seg = SceneSegmenter(model, InferenceConfig(
        patch_size=P, border_correction=None, num_classes=num_classes),
        returns_logits=spec.returns_logits, device="cpu")
    return seg.predict_scene(img).numpy()


def test_esa_writes_the_engine_palette(tmp_path):
    path, img = raster(tmp_path, "modena.png", seed=1)
    cfg = config(tmp_path, str(path), output=str(tmp_path / "patches"))
    esa_cli.run(dict(cfg))
    got = np.asarray(Image.open(tmp_path / "esa.png"))
    assert got.shape == (2 * P, 3 * P, 3)
    want = engine_labels(cfg, img)
    assert len(np.unique(want)) > 1
    np.testing.assert_array_equal(got, PALETTE[want])
    patches = sorted(int(f.stem) for f in (tmp_path / "patches").glob("*"))
    assert patches == list(range(6))
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "patches" / "4.png")),
        got[P:, P:2 * P])


def test_esa_image_list(tmp_path):
    rasters = [raster(tmp_path, f"r{i}.png", seed=2 + i) for i in range(2)]
    cfg = config(tmp_path, [str(p) for p, _ in rasters])
    esa_cli.run(dict(cfg))
    for i, (_, img) in enumerate(rasters):
        got = np.asarray(Image.open(tmp_path / f"esa_{i}.png"))
        np.testing.assert_array_equal(got, PALETTE[engine_labels(cfg, img)])


def test_esa_config_validation(tmp_path, capsys):
    with pytest.raises(KeyError, match="image"):
        esa_cli.run({"net": "SwinUnetTiny"})
    path, _ = raster(tmp_path, "a.png", seed=4)
    esa_cli.run(config(tmp_path, str(path), border_corection=64))
    out = capsys.readouterr().out
    assert "unknown esa config keys" in out and "border_corection" in out
    with pytest.raises(ValueError, match="mesh 0x2 does not cover 1 "
                                         "devices"):
        esa_cli.run(config(tmp_path, str(path), mesh={"spatial": 2}))
