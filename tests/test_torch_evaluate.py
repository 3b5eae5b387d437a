"""The port's evaluation entry point against the JAX package's, on the
CPU.

* ``cvcs_tpu_torch.cli.evaluate.evaluate`` and
  ``cvcs_tpu.cli.evaluate.evaluate`` on one synthetic GID15-layout set (2
  scenes of 128 x 192, p 64: 12 patches in batches of 5, so the last
  batch of each scene is padded) with ``precision: f32``,
  ``ignore_background`` and SwinUnetTiny, the cheapest ported net: JAX
  with its seed-0 initialisation, the port with the same variables from
  an ``.npz``. The confusion matrices may differ by at most 8 of the
  49,152 pixels (logits within f32 rounding can swap a near tie; none
  did when this was written) and the metric dicts must then agree.
* ``print_metrics`` prints the reference's two tables exactly as the JAX
  package does and returns the same dict; ``silent`` prints nothing.
* ``plot_confusion`` and ``plot_priors`` write their files (matplotlib).
* With no card and no ``device: cpu`` the entry point raises, as does
  ``mesh`` (not yet ported); ``load_context: true`` evaluates, with the
  same metrics as without (SwinUnetTiny reads no context).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.cli import common as jcommon
from cvcs_tpu.cli import evaluate as jevaluate
from cvcs_tpu.metrics import scores as jscores
from cvcs_tpu_torch.cli import evaluate as tevaluate
from cvcs_tpu_torch.metrics import plots, scores
from cvcs_tpu_torch.weights import flatten_variables

P = 64
PIXELS_MOVED = 8                    # of 2 x 128 x 192 = 49,152


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_scenes(root: Path, n: int, seed: int, h: int = 128,
                 w: int = 192) -> str:
    """A GID15-layout set of n h x w scenes with 16 x 16 label blocks."""
    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        m = np.kron(rng.integers(0, 16, (h // 16, w // 16), dtype=np.uint8),
                    np.ones((16, 16), np.uint8))
        Image.fromarray(img).save(root / "Image__8bit_NirRGB" / f"s{i}.png")
        Image.fromarray(m).save(root / "Annotation__index" / f"s{i}_15label.png")
    return str(root)


def _recorded(monkeypatch, module, into: list):
    """Record the confusion matrix ``module.print_metrics`` is given."""
    original = module.print_metrics

    def record(conf, *a, **kw):
        into.append(np.asarray(conf))
        return original(conf, *a, **kw)

    monkeypatch.setattr(module, "print_metrics", record)


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    cfg = dict(dataset=write_scenes(tmp_path / "set", 2, seed=11),
               net="SwinUnetTiny", patch_size=P, num_classes=15,
               precision="f32", ignore_background=True, batch_size=5,
               device="cpu")
    model, _, _ = jcommon.build_net(cfg)
    npz = tmp_path / "weights.npz"
    np.savez(npz, **flatten_variables(jcommon.init_variables(model, P)))

    confs: list = []
    _recorded(monkeypatch, jscores, confs)
    with jcommon.device_context(cfg):
        want = jevaluate.evaluate(cfg)
    _recorded(monkeypatch, scores, confs)
    got = tevaluate.evaluate(dict(cfg, load_checkpoint=str(npz)))
    jconf, tconf = confs
    assert jconf.sum() == tconf.sum() > 0
    moved = int(np.abs(jconf - tconf).sum()) // 2
    print(f"pixels moved between the confusion matrices: {moved}")
    assert moved <= PIXELS_MOVED, moved
    if moved == 0:
        assert got == want
    else:
        assert set(got) == set(want)


def test_print_metrics_matches_jax(capsys):
    rng = np.random.default_rng(3)
    conf = rng.integers(0, 500, (16, 16))
    conf[4] = 0                                    # class 4 not in target
    want = jscores.print_metrics(conf)
    jax_out = capsys.readouterr().out
    got = scores.print_metrics(conf)
    assert capsys.readouterr().out == jax_out
    assert got == want
    borders = [ln for ln in jax_out.splitlines() if ln.startswith("+")]
    assert len(borders) == 6                       # two bordered tables
    assert scores.print_metrics(conf, silent=True) == want
    assert capsys.readouterr().out == ""


def test_plots_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    conf = np.random.default_rng(4).integers(0, 1000, (16, 16))
    norm = conf / conf.sum(1, keepdims=True)
    plots.plot_confusion(norm, str(tmp_path / "confusion.png"))
    plots.plot_priors(conf, str(tmp_path / "priors.png"))
    for name in ("confusion.png", "priors.png"):
        assert (tmp_path / name).stat().st_size > 1000


def test_evaluate_refuses(tmp_path):
    cfg = dict(dataset=write_scenes(tmp_path / "set", 1, seed=12),
               net="SwinUnetTiny", patch_size=P)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tevaluate.evaluate(cfg)
    with pytest.raises(NotImplementedError, match="item 14"):
        tevaluate.evaluate(dict(cfg, device="cpu", mesh={"data": 2}))
    plain = tevaluate.evaluate(dict(cfg, device="cpu"))
    assert tevaluate.evaluate(dict(cfg, device="cpu",
                                   load_context=True)) == plain
