"""Port's training pieces vs the JAX package's, on the CPU, from the same
numpy draws and weights.

* losses (CEL, wCEL, MSE, DL, DEL, with and without ``ignore_background``,
  with out-of-range labels) and their gradients w.r.t. the logits;
* SGD1, SGD2, ADAM1 over 3 steps against the optax bundles;
* train-mode BatchNorm (output and running statistics) against the JAX
  package's ``BatchNorm``;
* SwinUnetTiny train steps (the recipe's wCEL with ignore_background and
  SGD2) from weights carried by ``cvcs_tpu_torch.weights``, against JAX
  ``make_train_step`` with ``SwinUNet(fused_attn=True)`` (its Pallas
  forward and backward in interpret mode): the loss of every step, then
  every parameter and BN running statistic after steps 1 and 3; and one
  ``grad_accum=2`` step.

Tolerances: f32 1e-4 * max(1, |ref|max) per tensor (only summation
orders differ); bf16 5e-2 * scale, as the model-logit test (rounding
points of the two frameworks differ by an ulp and the difference
propagates). The model steps run at p 64: at p 32 with batch 2 the
deepest decoder BatchNorm normalises 8 samples per channel, and bf16-ulp
parameter differences grow there to 0.14 * scale in one running mean
after 3 steps (observed); at p 64 the largest bf16 difference after 3
steps is 2e-3 * scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models.blocks import BatchNorm as JaxBatchNorm
from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu.ops import losses as jlosses
from cvcs_tpu.train import build_optimizer as jax_build_optimizer
from cvcs_tpu.train.state import TrainState as JaxTrainState
from cvcs_tpu.train.step import make_train_step
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.models.blocks import batch_norm_train
from cvcs_tpu_torch.ops import losses as tlosses
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import stats_step, train_step
from cvcs_tpu_torch.weights import swin_state_dict

TOL = {"f32": 1e-4, "bf16": 5e-2}
NUM_CLASSES = 16
DEPTHS = (1, 1, 2, 1)          # SwinUnetTiny


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


def _close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("ignore_background", [False, True])
@pytest.mark.parametrize("name", ["CEL", "wCEL", "MSE", "DL", "DEL"])
def test_losses_match_jax(name, ignore_background):
    rng = np.random.default_rng(1)
    c = 5
    logits = rng.standard_normal((2, 4, 6, c)).astype(np.float32) * 3
    labels = rng.integers(-1, c + 2, (2, 4, 6)).astype(np.int32)
    labels[0, 0, :3] = (-1, c, 255)          # out of range: weight 0
    weights = rng.uniform(0.2, 2.0, c).astype(np.float32)
    jfn = jlosses.build_loss(name, weights=weights,
                             ignore_background=ignore_background)
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits),
                                              jnp.asarray(labels))
    tfn = tlosses.build_loss(name, weights=weights,
                             ignore_background=ignore_background)
    x = torch.from_numpy(logits).requires_grad_()
    got = tfn(x, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32
    _close(got.detach(), want, 1e-5, "loss")
    _close(x.grad, want_grad, 1e-5, "grad")


@pytest.mark.parametrize("name", ["SGD1", "SGD2", "ADAM1"])
def test_optimizers_match_optax(name):
    rng = np.random.default_rng(2)
    shapes = {"w": (4, 3), "b": (3,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    epochs = 7
    jb = jax_build_optimizer(name, epochs=epochs)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jb.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    tb = build_optimizer(name, tp.values(), epochs=epochs)
    for epoch, g in enumerate(grads):        # one step per epoch: the LR moves
        lr = jb.lr_for_epoch(epoch)
        upd, jst = jb.tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                jst, jp)
        jp = {k: jp[k] - jnp.float32(lr) * upd[k] for k in jp}
        assert tb.set_epoch(epoch) == lr
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        tb.opt.step()
        for k in tp:
            _close(tp[k].detach(), jp[k], 1e-6, f"{name} {k} step {epoch}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_train_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((4, 6, 6, 8)) * 2 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.standard_normal(8).astype(np.float32)
    mean = rng.standard_normal(8).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 8).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    bn = JaxBatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=jdt)
    want, upd = bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}},
        jnp.asarray(x, jdt), mutable=["batch_stats"])
    tbn = torch.nn.BatchNorm2d(8)
    with torch.no_grad():
        tbn.weight.copy_(torch.from_numpy(scale))
        tbn.bias.copy_(torch.from_numpy(bias))
        tbn.running_mean.copy_(torch.from_numpy(mean))
        tbn.running_var.copy_(torch.from_numpy(var))
    got = batch_norm_train(torch.from_numpy(x).to(tdt), tbn)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "f32" else 1e-2
    _close(got.float(), np.asarray(want, np.float32), tol, "output")
    _close(tbn.running_mean, upd["batch_stats"]["mean"], 1e-6, "mean")
    _close(tbn.running_var, upd["batch_stats"]["var"], 1e-6, "var")


@pytest.fixture(scope="module")
def tiny_variables():
    """JAX SwinUnetTiny variables (init on the einsum path, which has the
    same parameter tree), BN running stats moved off 0/1."""
    model, _ = jax_build_model("SwinUnetTiny", NUM_CLASSES,
                               dtype=jnp.float32, fused_attn=False)
    variables = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(4)
    for dec in variables["batch_stats"].values():
        for bn in dec.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def _batches(n, b=2, px=64, seed=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, px, px, 3)).astype(np.uint8),
             rng.integers(0, NUM_CLASSES, (b, px, px)).astype(np.int32))
            for _ in range(n)]


def _run_both(variables, dtype, batches, accum=1):
    """Train both packages on ``batches``; yields (step, jax state, jax
    loss, port state, port loss) after every step."""
    weights = np.random.default_rng(6).uniform(
        0.5, 2.0, NUM_CLASSES).astype(np.float32)
    weights[0] = 0.0
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16

    jmodel, _ = jax_build_model("SwinUnetTiny", NUM_CLASSES, dtype=jdt,
                                fused_attn=True)
    jopt = jax_build_optimizer("SGD2")
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jopt.init(params), apply_fn=jmodel.apply, tx=jopt.tx)
    jstep = make_train_step(jlosses.build_loss(
        "wCEL", weights=weights, ignore_background=True), accum=accum)
    lr = jnp.float32(jopt.lr_for_epoch(0))

    model, _ = build_model("SwinUnetTiny", NUM_CLASSES, device="cpu",
                           dtype=tdt)
    model.load_state_dict(swin_state_dict(variables, DEPTHS), strict=True)
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    loss_fn = tlosses.build_loss("wCEL", weights=weights,
                                 ignore_background=True)
    for i, (img, msk) in enumerate(batches):
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(msk),
                              jnp.zeros((), jnp.uint8), lr,
                              jax.random.key(0))
        loss = train_step(state, loss_fn, torch.from_numpy(img),
                          torch.from_numpy(msk), accum=accum)
        yield i + 1, jstate, float(jloss), state, float(loss)


def _compare_state(jstate, state, tol, step):
    want = swin_state_dict({"params": jax.device_get(jstate.params),
                            "batch_stats": jax.device_get(jstate.batch_stats)},
                           DEPTHS)
    got = state.model.state_dict()
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        _close(got[k], v, tol, f"{k} after step {step}")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swin_train_steps_match_jax(tiny_variables, dtype):
    tol = TOL[dtype]
    for step, jstate, jloss, state, loss in _run_both(
            tiny_variables, dtype, _batches(3)):
        assert np.isfinite(loss)
        _close(loss, jloss, tol, f"loss at step {step}")
        if step in (1, 3):
            _compare_state(jstate, state, tol, step)
    assert state.step == 3


def test_grad_accum_matches_jax(tiny_variables):
    """grad_accum=2: two micro-batches in order (BN stats updated per
    micro-batch), the mean of their grads, the mean of their losses."""
    for step, jstate, jloss, state, loss in _run_both(
            tiny_variables, "f32", _batches(1, b=4, px=32, seed=7), accum=2):
        _close(loss, jloss, TOL["f32"], "loss")
        _compare_state(jstate, state, TOL["f32"], step)


def test_frozen_stats_step_and_refresh():
    """``update_stats=False`` (``bn_exact_stats: false``) trains without
    moving the BN running statistics; ``stats_step`` then refreshes them
    exactly as a train-mode forward does."""
    model, _ = build_model("SwinUnetTiny", NUM_CLASSES, device="cpu",
                           dtype=torch.float32)
    state = TrainState(model, build_optimizer("SGD2", model.parameters()))
    state.optimizer.set_epoch(0)
    img, msk = (torch.from_numpy(a) for a in _batches(1, px=32)[0])
    loss_fn = tlosses.build_loss("CEL")

    def stats():
        return {k: v.clone() for k, v in model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    before = stats()
    w0 = model.head.out.weight.detach().clone()
    train_step(state, loss_fn, img, msk, update_stats=False)
    assert not torch.equal(model.head.out.weight, w0)
    for k, v in stats().items():
        assert torch.equal(v, before[k]), k
    twin, _ = build_model("SwinUnetTiny", NUM_CLASSES, device="cpu",
                          dtype=torch.float32)
    twin.load_state_dict(model.state_dict())
    stats_step(state, img)
    with torch.no_grad():
        twin.train()(img.float())
    for k, v in stats().items():
        assert not torch.equal(v, before[k]), k
        assert torch.equal(v, twin.state_dict()[k]), k

