"""Checkpoint interop of the port against the JAX package, on the CPU.

* Reference pickles: the port's own seeded weights of Unet, Unetv2,
  Resnet50, MobileNet and SegformerMod (full width), renamed with each
  wrapper's DataParallel prefixes and wrapped in the reference's 12 keys,
  whose confusion histories hold numpy arrays and metric objects. The
  JAX package's ``load_reference_checkpoint`` and the port's
  ``restore_variables`` read the one pickle; their f32 logits at p 32
  agree within 1e-4 * max(1, |JAX|max) (only summation orders differ).
  The port's loader also reads a pickle whose metric objects come from a
  package this host lacks, and runs nothing of it.
* Orbax: one JAX SGD2 train step (wCEL with ignore_background) on Unetv2
  and on SwinUnetTiny at p 32, written by the JAX package's
  ``save_checkpoint``; the port's ``load_checkpoint`` restores it:
  weights and BatchNorm statistics equal to the bridge's of the saved
  variables bit for bit, momentum buffers equal to the bridge's of
  optax's trace bit for bit, the step and the meta; the next step from
  there matches the JAX package's next step within the f32 tolerance of
  ``tests/test_torch_train.py`` (1e-4 * scale per tensor). JAX's
  SwinUnetTiny runs its einsum attention, the plain reference of its
  Pallas kernel. ADAM1's state (moments and count) on SwinUnetTiny
  restores bit for bit, and the next update from the same gradients
  matches optax's within the same tolerance.
* ``load_checkpoint: auto``: ``cli.train`` over a directory holding the
  JAX package's ``checkpoint1`` (after one SGD2 step of Unetv2) beside a
  ``checkpoint2`` with ``meta.json`` alone and a bare
  ``*.orbax-checkpoint-tmp-*`` directory resumes at epoch 1 with the
  bridge's weights; ``prune_checkpoints`` deletes what the JAX package's
  prune deletes and leaves the half-written ones.
* Async saves (after ``tests/test_async_checkpoint.py``): the round trip;
  a write held in flight is passed by ``latest_checkpoint`` and
  ``prune_checkpoints`` and lands after ``wait_for_saves``; the snapshot
  is the state when the save was issued, whatever the next step does in
  place; a torn ``meta.json`` degrades to empty metadata; a ``Trainer``
  with ``async_checkpoints`` writes both epochs and resumes.
"""

import json
import pickle
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models import build_model as jax_build_model
from cvcs_tpu.ops import losses as jlosses
from cvcs_tpu.train import build_optimizer as jax_build_optimizer
from cvcs_tpu.train import checkpoint as jax_ckpt
from cvcs_tpu.train.state import TrainState as JaxTrainState
from cvcs_tpu.train.step import make_train_step
from cvcs_tpu.utils import torch_import as jimport
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.ops import losses as tlosses
from cvcs_tpu_torch.train import checkpoint as ckpt_lib
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step
from cvcs_tpu_torch.utils import torch_import
from cvcs_tpu_torch.weights import jax_state_dict

TOL = 1e-4                              # x max(1, |JAX|max), f32
NC = 16
P = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                     else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=what)


class ConfusionMetric:
    """A stand-in for the reference's confusion-metric objects."""

    def __init__(self, mat):
        self.mat = mat


# -- reference pickles ---------------------------------------------------------
def _with_wrapper_prefixes(sd: dict, net: str) -> dict:
    """The keys as the reference's wrappers saved them under DataParallel:
    ``module.model.`` before torchvision's names (Resnet101/50),
    ``module.`` before them (MobileNet, whose ``custom_load`` turns it into
    ``model.``), ``module.`` before the rest."""
    prefix = "module.model." if net in ("Resnet101", "Resnet50") else "module."
    return {prefix + k: v for k, v in sd.items()}


def reference_pickle(sd: dict, net: str, path, metric=ConfusionMetric):
    """The state dict ``sd`` as the reference's 12-key ``torch.save``,
    with an optimizer and a scheduler state dict, loss lists, and
    confusion histories of a numpy array and a metric object."""
    weight = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.SGD([weight], lr=6e-3, momentum=0.9)
    weight.grad = torch.ones(3)
    opt.step()                                     # a momentum buffer
    sched = torch.optim.lr_scheduler.PolynomialLR(opt, total_iters=20)
    conf = np.arange(NC * NC, dtype=np.int64).reshape(NC, NC)
    torch.save({
        "epoch": 4,
        "model_state_dict": _with_wrapper_prefixes(sd, net),
        "optimizer_state_dict": opt.state_dict(),
        "scheduler_state_dict": sched.state_dict(),
        "training_loss_values": [2.5, 2.25],
        "validation_loss_values": [2.4],
        "macro_precision": [],
        "weighted_precision": [],
        "batch_size": 10,
        "conf_flat": [conf],
        "conf_normalized": [metric(conf / conf.sum(1, keepdims=True))],
        "optimizer": "SGD2",
    }, path)
    return path


@pytest.mark.parametrize("net", ["Unet", "Unetv2", "Resnet50", "MobileNet",
                                 "SegformerMod"])
def test_reference_pickle_logits_match_jax(net, tmp_path):
    model, _ = build_model(net, NC, device="cpu", seed=3,
                           dtype=torch.float32)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    path = reference_pickle(want, net, tmp_path / "checkpoint5")
    with torch.no_grad():
        for v in model.state_dict().values():
            v.zero_()
    common.restore_variables({"load_checkpoint": str(path), "net": net},
                             model)
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())

    variables = jimport.load_reference_checkpoint(str(path), net)
    jmodel, _ = jax_build_model(net, NC, dtype=jnp.float32)
    x = np.random.default_rng(1).uniform(0, 255, (1, P, P, 3)).astype(
        np.float32)
    want = jax.jit(lambda v, a: jmodel.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x))
    _close(logits, np.asarray(want), f"{net} logits")


def test_reference_pickle_needs_no_metric_package(tmp_path):
    """The confusion objects' class lives in a module this host lacks:
    they load as inert placeholders, numpy arrays too, and the model
    loads; a net the JAX package has no importer for is refused."""
    metric = type("MulticlassConfusionMatrix", (ConfusionMetric,), {})
    metric.__module__ = "absent_metrics"
    sd = {"encode1.0.layer.0.weight": torch.ones(2, 3)}
    mod = types.ModuleType(metric.__module__)
    setattr(mod, metric.__name__, metric)
    sys.modules[metric.__module__] = mod          # only to write the file
    try:
        path = reference_pickle(sd, "Unet", tmp_path / "ck", metric)
    finally:
        del sys.modules[metric.__module__]
    with pytest.raises((ModuleNotFoundError, pickle.UnpicklingError)):
        torch.load(path, weights_only=False)
    loaded = torch_import.load_pickle(path)
    assert isinstance(loaded["conf_normalized"][0], torch_import.Placeholder)
    assert isinstance(loaded["conf_flat"][0], torch_import.Placeholder)
    assert loaded["training_loss_values"] == [2.5, 2.25]
    assert loaded["scheduler_state_dict"]["total_iters"] == 20
    got = torch_import.reference_state_dict(loaded, "Unet")
    assert list(got) == list(sd) and torch.equal(got[list(sd)[0]],
                                                 torch.ones(2, 3))
    with pytest.raises(ValueError, match="no importer"):
        torch_import.reference_state_dict(loaded, "SwinUnetTiny")


# -- Orbax -------------------------------------------------------------------------
_IMPORT = {"Unetv2": lambda sd: jimport.import_unet(sd, "transpose"),
           "SwinUnetTiny": lambda sd: jimport.import_swin(sd, (1, 1, 2, 1))}
_WEIGHTS = np.random.default_rng(6).uniform(0.5, 2.0, NC).astype(np.float32)
_WEIGHTS[0] = 0.0


def _jax_state(net, opt_name, seed):
    """A JAX train state of the port's seeded weights (carried by the JAX
    package's torch importer: no JAX initialisation to compile)."""
    torch_model, _ = build_model(net, NC, device="cpu", seed=seed)
    variables = _IMPORT[net]({k: v.numpy() for k, v in
                              torch_model.state_dict().items()})
    kw = {"fused_attn": False} if net.startswith("Swin") else {}
    jmodel, _ = jax_build_model(net, NC, dtype=jnp.float32, **kw)
    jopt = jax_build_optimizer(opt_name, epochs=3)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jax.jit(jopt.init)(params), apply_fn=jmodel.apply,
        tx=jopt.tx)
    return jstate, jnp.float32(jopt.lr_for_epoch(0))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _saved(jstate):
    return _host({"params": jstate.params, "batch_stats": jstate.batch_stats,
                  "opt_state": jstate.opt_state, "step": jstate.step})


def _restore(net, opt_name, path, saved, moment_trees):
    """The port's ``load_checkpoint`` of ``path``: weights and BN
    statistics, and each optimizer moment (torch name -> the JAX tree),
    equal to the bridge's of ``saved`` bit for bit."""
    model, _ = build_model(net, NC, device="cpu", seed=9,
                           dtype=torch.float32)
    opt = build_optimizer(opt_name, model.parameters(), epochs=3)
    state, meta = ckpt_lib.load_checkpoint(path, TrainState(model, opt))
    assert meta["training_loss_values"] == [2.0] and meta["batch_size"] == 2
    assert state.step == int(saved["step"]) == 1
    want = jax_state_dict(model, saved)
    got = model.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    moments = {k: jax_state_dict(model, {"params": t,
                                         "batch_stats": saved["batch_stats"]})
               for k, t in moment_trees.items()}
    for name, p in model.named_parameters():
        for k, sd in moments.items():
            assert torch.equal(opt.opt.state[p][k], sd[name]), (k, name)
    return state


def _close_params(model, jstate, what):
    after = jax_state_dict(model, _host({"params": jstate.params,
                                         "batch_stats": jstate.batch_stats}))
    got = model.state_dict()
    for k, v in after.items():
        if not k.endswith("num_batches_tracked"):
            _close(got[k], v, f"{k} {what}")


@pytest.mark.parametrize("net", ["Unetv2", "SwinUnetTiny"])
def test_orbax_checkpoint_resumes_like_jax(net, tmp_path):
    """SGD2: a JAX step, its checkpoint, then the next step on both
    sides."""
    jstate, lr = _jax_state(net, "SGD2", seed=2)
    jstep = make_train_step(jlosses.build_loss(
        "wCEL", weights=_WEIGHTS, ignore_background=True))
    rng = np.random.default_rng(4)
    (img1, msk1), (img2, msk2) = [
        (rng.integers(0, 256, (2, P, P, 3)).astype(np.uint8),
         rng.integers(0, NC, (2, P, P)).astype(np.int32)) for _ in range(2)]
    ctx, key = jnp.zeros((), jnp.uint8), jax.random.key(0)
    jstate, _ = jstep(jstate, jnp.asarray(img1), jnp.asarray(msk1), ctx, lr,
                      key)
    path = jax_ckpt.save_checkpoint(tmp_path, 0, jstate, [2.0], [2.5], 2,
                                    "SGD2")
    saved = _saved(jstate)
    jstate, jloss = jstep(jstate, jnp.asarray(img2), jnp.asarray(msk2), ctx,
                          lr, key)

    state = _restore(net, "SGD2", path, saved,
                     {"momentum_buffer": saved["opt_state"][1].trace})
    state.optimizer.set_epoch(0)
    loss = train_step(state, tlosses.build_loss(
        "wCEL", weights=_WEIGHTS, ignore_background=True),
        torch.from_numpy(img2), torch.from_numpy(msk2))
    _close(loss, float(jloss), "loss of the next step")
    _close_params(state.model, jstate, "after the next step")
    assert state.step == int(jstate.step) == 2


def test_orbax_adam_state_resumes_like_optax(tmp_path):
    """ADAM1 on SwinUnetTiny: optax's state after one update (random
    gradients, no model to compile) restores into torch's Adam (moments
    and step, which sets the bias correction), and the next update from
    the same gradients on both sides lands on the same parameters. Real
    train steps are not used here: Adam divides each gradient by its own
    RMS, so an element whose gradient is at the level of the two
    frameworks' rounding moves by up to the learning rate either way."""
    jstate, lr = _jax_state("SwinUnetTiny", "ADAM1", seed=2)
    rng = np.random.default_rng(8)

    def grads():
        return jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 1, p.shape), jnp.float32),
            jstate.params)

    @jax.jit
    def update(jstate, g):
        u, opt_state = jstate.tx.update(g, jstate.opt_state, jstate.params)
        params = jax.tree_util.tree_map(lambda p, v: p - lr * v,
                                        jstate.params, u)
        return jstate.replace(step=jstate.step + 1, params=params,
                              opt_state=opt_state)

    jstate = update(jstate, grads())
    path = jax_ckpt.save_checkpoint(tmp_path, 0, jstate, [2.0], [2.5], 2,
                                    "ADAM1")
    saved = _saved(jstate)
    adam = saved["opt_state"]
    state = _restore("SwinUnetTiny", "ADAM1", path, saved,
                     {"exp_avg": adam.mu, "exp_avg_sq": adam.nu})
    model, opt = state.model, state.optimizer
    assert all(float(opt.opt.state[p]["step"]) == int(adam.count) == 1
               for p in model.parameters())
    g2 = grads()
    jstate = update(jstate, g2)
    bridged = jax_state_dict(model, {"params": _host(g2),
                                     "batch_stats": saved["batch_stats"]})
    for name, p in model.named_parameters():
        p.grad = bridged[name].clone()
    opt.set_epoch(0)
    opt.opt.step()
    _close_params(model, jstate, "after the next Adam update")


# -- async saves ------------------------------------------------------------------
def _tiny_state(seed=1):
    model, _ = build_model("SwinUnetTiny", NC, device="cpu", seed=seed)
    return TrainState(model, build_optimizer("SGD2", model.parameters()))


def _step(state, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.integers(0, 256, (1, P, P, 3)).astype(
        np.uint8))
    msk = torch.from_numpy(rng.integers(0, NC, (1, P, P)).astype(np.int32))
    train_step(state, tlosses.build_loss("CEL"), img, msk)


def _equal_payload(path, state_dict, opt_dict):
    saved = torch.load(path / ckpt_lib.STATE, weights_only=True)
    assert all(torch.equal(saved["model"][k], v)
               for k, v in state_dict.items())
    for i, entry in opt_dict["state"].items():
        assert torch.equal(saved["optimizer"]["state"][i]["momentum_buffer"],
                           entry["momentum_buffer"])


def test_async_save_roundtrip_and_snapshot(tmp_path):
    state = _tiny_state()
    _step(state)                                   # a momentum to save
    want = ckpt_lib.host_copy({"m": state.model.state_dict(),
                               "o": state.optimizer.opt.state_dict()})
    path = ckpt_lib.save_checkpoint(tmp_path, 0, state, [1.0], [2.0], 4,
                                    "SGD2", async_save=True)
    _step(state, seed=1)                           # in place, at once
    ckpt_lib.wait_for_saves()
    _equal_payload(path, want["m"], want["o"])
    restored, meta = ckpt_lib.load_checkpoint(path, _tiny_state(seed=5))
    assert meta["epoch"] == 0 and meta["batch_size"] == 4
    assert restored.step == 1
    assert all(torch.equal(restored.model.state_dict()[k], v)
               for k, v in want["m"].items())


def test_write_in_flight_is_passed_by(tmp_path, monkeypatch):
    state = _tiny_state()
    for epoch in range(2):
        ckpt_lib.save_checkpoint(tmp_path, epoch, state, [], [], 4, "SGD2")
    release, started = threading.Event(), threading.Event()
    save = torch.save

    def held(obj, f):
        started.set()
        release.wait(30)
        save(obj, f)

    monkeypatch.setattr(torch, "save", held)
    ckpt_lib.save_checkpoint(tmp_path, 2, state, [], [], 4, "SGD2",
                             async_save=True)
    assert started.wait(30)
    assert (tmp_path / "checkpoint3" / "meta.json").exists()
    assert ckpt_lib.latest_checkpoint(tmp_path) == tmp_path / "checkpoint2"
    assert ckpt_lib.prune_checkpoints(tmp_path, 1) == [tmp_path /
                                                       "checkpoint1"]
    assert (tmp_path / "checkpoint3").is_dir()
    release.set()
    ckpt_lib.wait_for_saves()
    assert ckpt_lib.latest_checkpoint(tmp_path) == tmp_path / "checkpoint3"
    assert ckpt_lib.prune_checkpoints(tmp_path, 1) == [tmp_path /
                                                       "checkpoint2"]


def test_torn_meta_degrades(tmp_path):
    state = _tiny_state()
    path = ckpt_lib.save_checkpoint(tmp_path, 0, state, [1.0], [2.0], 4,
                                    "SGD2", async_save=True)
    ckpt_lib.wait_for_saves()
    assert not (path / "meta.json.tmp").exists()
    (path / "meta.json").write_text('{"epoch": 0, "batch_si')
    restored, meta = ckpt_lib.load_checkpoint(path, _tiny_state(seed=5))
    assert meta == {}
    assert all(torch.equal(restored.model.state_dict()[k], v)
               for k, v in state.model.state_dict().items())


def test_trainer_async_checkpoints_resume(tmp_path):
    from test_torch_repairs import write_scenes

    from cvcs_tpu_torch.cli import train as train_cli

    data = write_scenes(tmp_path / "set", 2, seed=31, h=64, w=96)
    cfg = dict(train=data, validation=data,
               checkpoint_directory=str(tmp_path / "ck"), device="cpu",
               net="SwinUnetTiny", epochs=2, chunk_size=2,
               validation_chunk_size=2, patch_size=P, batch_size=6,
               loss="CEL", opt="SGD2", precision_evaluation_freq=9,
               precision="f32", async_checkpoints=True, keep_checkpoints=1)
    trainer = train_cli.build_trainer(cfg)
    trainer.train()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "checkpoint2"]
    meta = json.loads((tmp_path / "ck" / "checkpoint2" /
                       "meta.json").read_text())
    assert meta["epoch"] == 1 and len(meta["training_loss_values"]) == 4
    resumed = train_cli.build_trainer(dict(cfg, epochs=3,
                                           load_checkpoint="auto"))
    assert resumed.last_epoch == 2 and resumed.state.step == 4
    assert all(torch.equal(resumed.state.model.state_dict()[k], v)
               for k, v in trainer.state.model.state_dict().items())
    resumed.train()
    assert ckpt_lib.latest_checkpoint(tmp_path / "ck") == (
        tmp_path / "ck" / "checkpoint3")


# -- load_checkpoint: auto over the JAX package's checkpoints ------------------
@pytest.fixture
def orbax_dir(tmp_path):
    """A checkpoint directory as the JAX train CLI leaves it: ``checkpoint1``
    from ``save_checkpoint`` after one SGD2 step of Unetv2 (wCEL with
    ignore_background), beside two half-written ones that must be passed
    by: ``checkpoint2`` holding only its ``meta.json`` and Orbax's
    temporary ``state.orbax-checkpoint-tmp-*``, and a bare
    ``checkpoint3.orbax-checkpoint-tmp-*`` directory."""
    jstate, lr = _jax_state("Unetv2", "SGD2", seed=2)
    jstep = make_train_step(jlosses.build_loss(
        "wCEL", weights=_WEIGHTS, ignore_background=True))
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, P, P, 3)).astype(np.uint8)
    msk = rng.integers(0, NC, (2, P, P)).astype(np.int32)
    jstate, _ = jstep(jstate, jnp.asarray(img), jnp.asarray(msk),
                      jnp.zeros((), jnp.uint8), lr, jax.random.key(0))
    ck = tmp_path / "ck"
    path = jax_ckpt.save_checkpoint(ck, 0, jstate, [2.0], [2.5], 2, "SGD2")
    assert path.name == "checkpoint1"
    torn = ck / "checkpoint2"
    (torn / "state.orbax-checkpoint-tmp-1700000000").mkdir(parents=True)
    (torn / "meta.json").write_text((path / "meta.json").read_text())
    (ck / "checkpoint3.orbax-checkpoint-tmp-1700000001").mkdir()
    return ck, _saved(jstate)


def test_auto_resumes_from_the_jax_packages_checkpoint(orbax_dir, gid15_root,
                                                       tmp_path):
    """``cli.train`` with ``load_checkpoint: auto`` over a directory of the
    JAX package's checkpoints resumes at the Orbax one's epoch with the
    bridge's weights (it printed "starting fresh" and trained from random
    weights while ``_ranked`` counted only ``state.pt``)."""
    from cvcs_tpu_torch.cli import train as train_cli

    ck, saved = orbax_dir
    assert ckpt_lib.latest_checkpoint(ck) == ck / "checkpoint1"
    trainer = train_cli.build_trainer(dict(
        train=str(gid15_root), validation=str(gid15_root),
        checkpoint_directory=str(ck), net="Unetv2", epochs=2, chunk_size=2,
        patch_size=P, batch_size=4, loss="wCEL", opt="SGD2",
        ignore_background=True, num_classes=NC - 1, precision="f32",
        device="cpu", load_checkpoint="auto"))
    assert trainer.last_epoch == 1 and trainer.state.step == 1
    assert trainer.training_loss_values == [2.0]
    want = jax_state_dict(trainer.state.model, saved)
    got = trainer.state.model.state_dict()
    assert all(torch.equal(got[k], want[k].to(got[k].dtype)) for k in want)


def test_prune_deletes_what_the_jax_prune_deletes(orbax_dir, tmp_path):
    """Landed Orbax checkpoints rank with the port's own by (N, preempt);
    both prunes delete the same ones and leave the half-written ones."""
    import shutil

    ck, _ = orbax_dir
    for name in ("checkpoint2_preempt", "checkpoint4"):
        shutil.copytree(ck / "checkpoint1", ck / name)
    listing = sorted(p.name for p in ck.iterdir())
    jax_copy, port_copy = tmp_path / "jax", tmp_path / "port"
    shutil.copytree(ck, jax_copy)
    shutil.copytree(ck, port_copy)
    assert ckpt_lib.latest_checkpoint(port_copy) == port_copy / "checkpoint4"
    jax_gone = sorted(p.name for p in jax_ckpt.prune_checkpoints(jax_copy, 2))
    port_gone = sorted(p.name for p in ckpt_lib.prune_checkpoints(port_copy,
                                                                  2))
    assert port_gone == jax_gone == ["checkpoint1"]
    left = sorted(p.name for p in port_copy.iterdir())
    assert left == sorted(p.name for p in jax_copy.iterdir())
    assert left == [n for n in listing if n != "checkpoint1"]
    assert "checkpoint2" in left and any("tmp" in n for n in left)
