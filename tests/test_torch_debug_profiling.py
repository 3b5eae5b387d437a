"""The port's debug plots (``cvcs_tpu_torch.utils.debug``) and profiling
(``cvcs_tpu_torch.utils.profiling``), and their train keys, on the CPU.

* A tiny train run through ``cli.train``'s ``main`` (SwinUnetTiny, p 32,
  the synthetic GID15 set: 2 chunks, 1 epoch, f32) with ``debug_plot``
  and ``profile_dir``: one ``debug_e0_c{c}_b0.png`` per chunk in
  ``debug/`` and a Chrome trace in ``<profile_dir>/trace.json`` naming
  the step's operations; neither key is in ``UNPORTED_TRAIN_KEYS`` now.
* ``cli.export`` of that run's checkpoint loads with ``strict=True`` into
  a fresh SwinUnetTiny whose logits equal the restored checkpoint's bit
  for bit.
* ``debug_plot`` and ``plot_activations`` draw the same pixels as the
  JAX package's; ``trace(None)`` records nothing; ``annotate`` names a
  span of the trace; ``StepTimer`` reports JAX's keys.
"""

import contextlib
import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from cvcs_tpu.utils import debug as jdebug
from cvcs_tpu.utils import profiling as jprofiling
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import export as texport
from cvcs_tpu_torch.cli import train as train_cli
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.utils import debug as tdebug
from cvcs_tpu_torch.utils import profiling as tprofiling
from tests.conftest import PATCH


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(gid15_root, tmp_path_factory):
    """One epoch through ``cli.train``'s ``main`` in a directory of its
    own (``debug/`` is relative to it, as in the JAX package)."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = dict(train=str(gid15_root), validation=str(gid15_root),
               checkpoint_directory=str(tmp / "ck"), device="cpu",
               net="SwinUnetTiny", epochs=1, chunk_size=2,
               validation_chunk_size=2, patch_size=PATCH, batch_size=8,
               loss="wCEL", opt="SGD2", ignore_background=True,
               augmentation="fused", precision="f32", seed=0,
               precision_evaluation_freq=5, debug_plot=True,
               profile_dir=str(tmp / "prof"))
    path = tmp / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    torch.set_num_threads(1)
    with contextlib.chdir(tmp):
        assert train_cli.main(["train", str(path)]) == 0
    return tmp


def test_train_writes_debug_plots_and_a_trace(run):
    assert sorted(p.name for p in (run / "debug").iterdir()) == [
        "debug_e0_c0_b0.png", "debug_e0_c1_b0.png"]
    for p in (run / "debug").iterdir():
        assert Image.open(p).size[0] > 0
    events = json.loads((run / "prof" / tprofiling.TRACE_FILE).read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any(n.startswith("aten::conv2d") for n in names)
    assert any("ConvolutionBackward" in n for n in names)
    assert not {"debug_plot", "profile_dir"} & set(
        train_cli.UNPORTED_TRAIN_KEYS)


def test_export_of_a_train_checkpoint_loads_strict(run):
    ckpt = str(run / "ck" / "checkpoint1")
    out = texport.export(dict(net="SwinUnetTiny", load_checkpoint=ckpt,
                              output=str(run / "swin.pt"), device="cpu"))
    fresh, _ = build_model("SwinUnetTiny", 16, device="cpu",
                           dtype=torch.bfloat16)
    fresh.load_state_dict(torch.load(out, weights_only=True), strict=True)
    trained, _, _ = common.build_net(
        dict(net="SwinUnetTiny", load_checkpoint=ckpt), torch.device("cpu"))
    common.restore_variables(dict(load_checkpoint=ckpt), trained)
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, PATCH, PATCH, 3)).astype(np.uint8))
    with torch.no_grad():
        assert torch.equal(fresh(x), trained(x))


def _pixels(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"))


def test_debug_plot_draws_what_jax_draws(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    mask = rng.integers(0, 17, (2, 16, 16)).astype(np.int32)
    for ctx in (None, img[::-1].copy()):
        want = jdebug.debug_plot(tmp_path / "jax", 0, 1, 2, img, mask, ctx)
        got = tdebug.debug_plot(
            tmp_path / "port", 0, 1, 2, torch.from_numpy(img),
            torch.from_numpy(mask),
            None if ctx is None else torch.from_numpy(ctx))
        assert got.name == want.name == "debug_e0_c1_b2.png"
        np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_plot_activations_draws_what_jax_draws(tmp_path):
    feats = np.random.default_rng(1).normal(size=(1, 8, 8, 20))
    want = jdebug.plot_activations(feats, tmp_path / "jax.png", title="x5")
    got = tdebug.plot_activations(torch.from_numpy(feats),
                                  tmp_path / "port.png", title="x5")
    np.testing.assert_array_equal(_pixels(got), _pixels(want))


def test_trace_annotate_and_step_timer(tmp_path):
    with tprofiling.trace(None):
        torch.ones(2).sum()
    assert not list(tmp_path.iterdir())
    with tprofiling.trace(str(tmp_path / "t")):
        with tprofiling.annotate("chunk_load"):
            torch.ones(4).sum()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert "chunk_load" in {e.get("name") for e in events["traceEvents"]}
    timer, jtimer = tprofiling.StepTimer(), jprofiling.StepTimer()
    assert timer.summary() == jtimer.summary() == {"steps": 0}
    for t in (timer, jtimer):
        for _ in range(3):
            with t.step():
                pass
    assert set(timer.summary()) == set(jtimer.summary())
    assert timer.summary()["steps"] == 3
