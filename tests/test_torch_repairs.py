"""Repairs of the port against the JAX package, on the CPU: one test for
each fault found by reading the two side by side.

1. ``restore_variables`` loads the port's own train checkpoints: a
   ``checkpointN/`` directory and its ``state.pt`` restore the saved
   weights strictly; so does the JAX package's Orbax ``checkpointN/``
   (written here by the JAX package's ``save_checkpoint``): the weights
   equal the JAX bridge's of the saved variables, bit for bit.
2. ``Trainer.last_metrics`` keeps the periodic evaluation's metric dict
   (None before the first), as the JAX trainer does.
3. ``cli.train`` prints its parameter and class-weight tables in the
   layout the JAX train CLI prints them (rendered here by the JAX
   package's own table class from the same values).
4. The reference preset's contrast jitter takes the mean of the floored
   grayscale as JAX's ``jnp.mean`` takes it (the sum times the reciprocal
   of the pixel count): equal on every patch of 40 draws of 8 patches at
   P 32, 97 and 224, where ``torch.mean`` on the CPU (the rule before the
   repair) differs on some. Both are given the same floored grayscale:
   XLA on the CPU contracts the grayscale's multiply-adds, so its own
   grayscale can differ from torchvision's separately rounded one by a
   level at a pixel.
"""

import contextlib
import io
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.utils.tables import get_table_cls as jax_table_cls
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import train as train_cli
from cvcs_tpu_torch.data import augment as taug
from cvcs_tpu_torch.data.palette import LABELS
from cvcs_tpu_torch.metrics import scores
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.train import checkpoint as ckpt_lib
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState, param_count


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


def test_restore_variables_loads_port_checkpoints(tmp_path):
    trained, _ = build_model("SwinUnetTiny", 16, device="cpu", seed=1)
    state = TrainState(trained, build_optimizer("SGD2", trained.parameters()))
    path = ckpt_lib.save_checkpoint(tmp_path, 0, state, [1.0], [1.0], 10,
                                    "SGD2")
    want = trained.state_dict()
    for ckpt in (path, path / ckpt_lib.STATE):
        fresh, _ = build_model("SwinUnetTiny", 16, device="cpu", seed=0)
        common.restore_variables({"load_checkpoint": str(ckpt)}, fresh)
        got = fresh.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want), ckpt
    from cvcs_tpu.models import build_model as jax_build_model
    from cvcs_tpu.train import build_optimizer as jax_build_optimizer
    from cvcs_tpu.train import checkpoint as jax_ckpt
    from cvcs_tpu.train import create_train_state
    from cvcs_tpu_torch.weights import jax_state_dict

    jmodel, _ = jax_build_model("SwinUnetTiny", 16, dtype=jnp.float32)
    jstate = create_train_state(jmodel, jax_build_optimizer("SGD2"),
                                jnp.zeros((1, 32, 32, 3), jnp.uint8), seed=3)
    orbax = jax_ckpt.save_checkpoint(tmp_path / "jax", 0, jstate, [1.0],
                                     [1.0], 10, "SGD2")
    common.restore_variables({"load_checkpoint": str(orbax)}, fresh)
    want = jax_state_dict(fresh, jax.tree_util.tree_map(np.asarray, {
        "params": jstate.params, "batch_stats": jstate.batch_stats}))
    got = fresh.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of SwinUnetTiny through ``cli.train`` on the CPU, with a
    periodic evaluation after it; the build's printed output."""
    base = tmp_path_factory.mktemp("repairs")
    cfg = dict(train=write_scenes(base / "train", 2, seed=21),
               validation=write_scenes(base / "val", 1, seed=22),
               checkpoint_directory=str(base / "ckpt"), device="cpu",
               net="SwinUnetTiny", epochs=1, chunk_size=2,
               validation_chunk_size=1, patch_size=64,
               batch_size=4, loss="wCEL", opt="SGD2", ignore_background=True,
               precision_evaluation_freq=1, num_classes=15, precision="f32")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        trainer = train_cli.build_trainer(cfg)
    before = getattr(trainer, "last_metrics", "missing")
    trainer.train()
    return trainer, out.getvalue(), before


def test_trainer_keeps_last_metrics(trained):
    trainer, _, before = trained
    assert before is None
    assert len(trainer.conf_history) == 1
    want = scores.print_metrics(trainer.conf_history[-1], silent=True)
    assert trainer.last_metrics == want
    assert set(want) == {"perclass_IoU", "mIoU", "precision_score",
                         "recall_score", "dice_score", "oa_score"}


def test_train_cli_prints_reference_tables(trained):
    trainer, printed, _ = trained
    table = jax_table_cls()
    loader_train, loader_val = trainer.train_loader, trainer.val_loader
    t = table(["Name", "Value"])
    t.add_row(["parameters", param_count(trainer.state.model)])
    t.add_row(["Patch size", loader_train.patch_size])
    t.add_row(["Tpe", loader_train.tpi])
    t.add_row(["Training patches", len(loader_train.idxs) * loader_train.tpi])
    t.add_row(["Validation patches", len(loader_val.idxs) * loader_val.tpi])
    assert str(t) in printed
    weights = loader_train.class_weights(16, True)
    wt = table(["Class", "Weight"])
    for i, w in enumerate(weights):
        wt.add_row([LABELS.get(i, str(i)), float(w)])
    assert str(wt) in printed


@pytest.mark.parametrize("p", [32, 97, 224])
def test_contrast_mean_matches_jax(p):
    rng = np.random.default_rng(p)
    jmean = jax.jit(jax.vmap(jnp.mean))
    divided = 0
    for _ in range(40):
        img = torch.from_numpy(
            rng.integers(0, 256, (8, p, p, 3)).astype(np.float32))
        gray = torch.floor(0.2989 * img[..., 0] + 0.587 * img[..., 1]
                           + 0.114 * img[..., 2])
        want = np.asarray(jmean(gray.numpy()))
        np.testing.assert_array_equal(taug.plane_mean(gray).numpy(), want)
        divided += int((gray.mean(dim=(1, 2)).numpy() != want).sum())
    # the draws tell the two rules apart, except where the pixel count is
    # a power of two: its reciprocal is exact and both rules agree
    assert divided > 0 or (p * p) & (p * p - 1) == 0
