"""Port serve daemon on the CPU (``device: cpu``, ``max_polls: 1``).

Two same-shape rasters (one batched multi-scene pass) and one of another
shape are served with weights carried from JAX variables through an
``.npz`` checkpoint. The masks must be the palette of the JAX engine's
labels for the same weights on at least 99.9% of pixels (both f32), the
manifest must journal all three, and a second run must process nothing.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.data.palette import PALETTE
from cvcs_tpu.infer import InferenceConfig as JaxInferenceConfig
from cvcs_tpu.infer import SceneSegmenter as JaxSceneSegmenter
from cvcs_tpu.models.swin import SwinUNet as JaxSwinUNet
from cvcs_tpu_torch.cli import predict as predict_cli
from cvcs_tpu_torch.cli import serve as serve_cli
from cvcs_tpu_torch.weights import flatten_variables
from test_torch_engine import scene

P, BC = 32, 64
# the registry's SwinUnetTiny, which the configs below name
TINY_NET = dict(dims=(32, 64, 128, 256), depths=(1, 1, 2, 1),
                heads=(1, 2, 4, 8), window=8)


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


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """SwinUnetTiny JAX variables (16 classes) saved as an .npz."""
    model = JaxSwinUNet(num_classes=16, dtype=jax.numpy.float32, **TINY_NET)
    variables = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.key(7)},
        jax.numpy.zeros((1, P, P, 3), jax.numpy.float32), train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    path = tmp_path_factory.mktemp("ckpt") / "swin_tiny.npz"
    np.savez(path, **flatten_variables(variables))
    return model, variables, path


def test_serve_writes_jax_equal_masks_and_journals(tmp_path, carried):
    model, variables, ckpt = carried
    watch = tmp_path / "in"
    watch.mkdir()
    rasters = {"a.png": scene(seed=11, h=96, w=128),
               "b.png": scene(seed=12, h=96, w=128),
               "c.png": scene(seed=13, h=64, w=96)}
    for name, arr in rasters.items():
        Image.fromarray(arr).save(watch / name)
    config = dict(watch_dir=str(watch), net="SwinUnetTiny",
                  load_checkpoint=str(ckpt), patch_size=P,
                  border_correction=BC, batch_tiles=5, num_classes=15,
                  precision="f32", device="cpu", max_polls=1, poll_s=0)
    assert serve_cli.serve(dict(config)) == 3

    jseg = JaxSceneSegmenter(model.apply, variables, JaxInferenceConfig(
        patch_size=P, border_correction=BC, batch_tiles=5, num_classes=16))
    out = watch / "output"
    for name, arr in rasters.items():
        mask = np.asarray(Image.open(out / name.replace(".png", "_mask.png")))
        want = PALETTE[np.asarray(jseg.predict_scene(arr))]
        assert mask.shape == want.shape
        assert (mask == want).all(-1).mean() >= 0.999, name
    entries = [json.loads(line) for line in
               (out / "manifest.jsonl").read_text().splitlines()]
    assert sorted(e["name"] for e in entries) == sorted(rasters)
    assert {e["name"]: e["batch"] for e in entries} == {
        "a.png": 2, "b.png": 2, "c.png": 1}
    # the journal: a restarted daemon re-processes nothing
    assert serve_cli.serve(dict(config)) == 0


def test_serve_journals_a_poison_pill(tmp_path, carried):
    _, _, ckpt = carried
    watch = tmp_path / "in"
    watch.mkdir()
    Image.fromarray(scene(seed=14, h=64, w=64)).save(watch / "ok.png")
    (watch / "bad.png").write_bytes(b"not an image")
    config = dict(watch_dir=str(watch), net="SwinUnetTiny",
                  load_checkpoint=str(ckpt), patch_size=P,
                  border_correction=BC, num_classes=15, precision="f32",
                  device="cpu", max_polls=2, poll_s=0, max_retries=2)
    assert serve_cli.serve(config) == 1
    entries = [json.loads(line) for line in
               (watch / "output" / "manifest.jsonl").read_text().splitlines()]
    errors = [e for e in entries if "error" in e]
    assert [e["name"] for e in errors] == ["bad.png"]
    assert errors[0]["attempts"] == 2


def test_predict_cli_writes_patches_and_map(tmp_path, carried, gid15_root):
    _, _, ckpt = carried
    out = tmp_path / "out"
    config = dict(dataset=str(gid15_root), net="SwinUnetTiny",
                  load_checkpoint=str(ckpt), patch_size=P,
                  border_correction=BC, num_classes=15, precision="f32",
                  device="cpu", mask_only=True, range=[0, 24],
                  output=str(out), out_image=str(tmp_path / "map.png"))
    predict_cli.predict(config)
    # 96 x 128 scenes at p 32 -> 12 tiles each: range [0, 24) = scenes 0, 1
    assert sorted(int(p.stem) for p in out.glob("*.png")) == list(range(24))
    assert Image.open(tmp_path / "map_0.png").size == (128, 96)
    # a few-patch range forwards just the selected tiles
    few = tmp_path / "few"
    predict_cli.predict(dict(config, range=[13, 15], output=str(few),
                             out_image=None))
    assert sorted(p.name for p in few.glob("*.png")) == ["13.png", "14.png"]
    np.testing.assert_array_equal(np.asarray(Image.open(few / "13.png")),
                                  np.asarray(Image.open(out / "13.png")))


def test_unported_paths_raise(tmp_path, capsys):
    base = dict(watch_dir=str(tmp_path), net="SwinUnetTiny", device="cpu",
                max_polls=1)
    with pytest.raises(NotImplementedError, match="multi-device"):
        serve_cli.serve(dict(base, mesh={"data": 2}))
    # the fullconv paths are ported (predict CLI); the serve vocabulary has
    # no such key, so, as in the JAX package, it warns and serves on the
    # window path
    assert serve_cli.serve(dict(base, fullconv_bands=2)) == 0
    out = capsys.readouterr().out
    assert "unknown serve config keys" in out and "fullconv_bands" in out
