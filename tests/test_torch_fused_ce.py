"""The port's fused weighted cross-entropy (K3 forward sums, K4 backward)
against the JAX package's, on the CPU: the plain versions that a CPU
tensor runs against JAX ``fused_cross_entropy(..., interpret=True)`` (its
Pallas kernels in interpret mode) and its ``jax.grad``, and against the
port's eager ``losses.cross_entropy``; a train step through
``build_fused_ce`` against one through the eager wCEL.

Inputs: N = 2 x 37 x 41 pixels (not a multiple of the TPU kernel's 1024
tile), C 16, labels that include 0, 255 and -1; weighted and unweighted,
``ignore_index`` None and 0. Tolerances: loss 1e-6 relative and dlogits
1e-6 * max(1, |ref|max) and 2e-6 * |ref|max (the same arithmetic in f32,
summed in another order; observed 4e-7 * |ref|max); against the eager
loss, whose per-pixel arithmetic is the same, 1e-6 relative and dlogits
1e-6 * |ref|max. The train step: loss 1e-6 relative, parameters
1e-5 * max(1, |p|max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.ops.pallas_ce import fused_cross_entropy as jax_fused_ce
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.ops import fused_ce
from cvcs_tpu_torch.ops import losses as tlosses
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import loss_step, train_step

B, H, W, C = 2, 37, 41, 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, H, W, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int32)
    labels[0, 0, :6] = (0, 255, -1, 0, 255, -1)
    labels[1, 5:9] = 0
    return logits, labels


def _weights(weighted):
    return (np.linspace(0.2, 1.8, C).astype(np.float32) if weighted
            else None)


def _port(logits, labels, weights, ignore_index, fn=None):
    x = torch.from_numpy(logits).requires_grad_()
    fn = fn or (lambda lg, lab: fused_ce.fused_cross_entropy(
        lg, lab, None if weights is None else torch.from_numpy(weights),
        ignore_index))
    loss = fn(x, torch.from_numpy(labels))
    loss.backward()
    return loss.detach(), x.grad


@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_matches_jax_interpret(weighted, ignore_index):
    logits, labels = _data()
    w = _weights(weighted)
    jw = None if w is None else jnp.asarray(w)
    want, want_grad = jax.value_and_grad(
        lambda lg: jax_fused_ce(lg, jnp.asarray(labels), jw, ignore_index,
                                True))(jnp.asarray(logits))
    loss, grad = _port(logits, labels, w, ignore_index)
    assert loss.dtype == torch.float32 and grad.dtype == torch.float32
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    want_grad = np.asarray(want_grad)
    scale = max(1.0, float(np.abs(want_grad).max()))
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=1e-6 * scale)
    # dlogits are ~1e-4 here: hold them to their own size as well
    np.testing.assert_allclose(grad.numpy(), want_grad, rtol=0,
                               atol=2e-6 * float(np.abs(want_grad).max()))
    # pixels of weight 0 (ignored or out-of-range labels) get zero rows
    dead = (labels < 0) | (labels >= C)
    if ignore_index is not None:
        dead |= labels == ignore_index
    assert not grad.numpy()[dead].any()


@pytest.mark.parametrize("ignore_index", [None, 0])
@pytest.mark.parametrize("weighted", [False, True])
def test_plain_matches_eager_cross_entropy(weighted, ignore_index):
    logits, labels = _data(1)
    w = _weights(weighted)
    loss, grad = _port(logits, labels, w, ignore_index)
    want, want_grad = _port(
        logits, labels, w, ignore_index,
        fn=lambda lg, lab: tlosses.cross_entropy(
            lg, lab, None if w is None else torch.from_numpy(w),
            ignore_index))
    assert abs(float(loss) - float(want)) <= 1e-6 * abs(float(want))
    np.testing.assert_allclose(
        grad.numpy(), want_grad.numpy(), rtol=0,
        atol=1e-6 * float(want_grad.abs().max()))


def test_plain_sums_and_grad_at_the_kernels_interface():
    """``ce_sums_plain`` / ``ce_grad_plain`` on (N, C) rows, as the kernels
    see them: a bf16 input comes back as bf16 dlogits."""
    logits, labels = _data(2)
    x = torch.from_numpy(logits).reshape(-1, C)
    lab = torch.from_numpy(labels).reshape(-1)
    w = fused_ce.effective_weights(_weights(True), C, 0)
    assert w[0] == 0 and w[1] > 0
    loss_sum, wsum = fused_ce.ce_sums_plain(x, lab, w)
    valid = (lab >= 0) & (lab < C)
    assert float(wsum) == pytest.approx(
        float(w[lab[valid].long()].sum()), rel=1e-6)
    want = tlosses.cross_entropy(x, lab, w)
    assert float(loss_sum / wsum) == pytest.approx(float(want), rel=1e-6)
    scale = torch.tensor(2.0) / wsum
    g16 = fused_ce.ce_grad_plain(x.to(torch.bfloat16), lab, w, scale)
    g32 = fused_ce.ce_grad_plain(x, lab, w, scale)
    assert g16.dtype == torch.bfloat16 and g32.dtype == torch.float32
    assert float((g16.float() - g32).abs().max()) <= 2e-2 * float(
        g32.abs().max())


def test_fused_ce_rejects_what_the_kernels_do_not_take():
    logits, labels = _data()
    x, lab = torch.from_numpy(logits), torch.from_numpy(labels)
    with pytest.raises(ValueError, match="labels must be"):
        fused_ce.fused_cross_entropy(x, lab[:, :-1])
    with pytest.raises(TypeError, match="integers"):
        fused_ce.fused_cross_entropy(x, lab.float())
    with pytest.raises(ValueError, match="weights must be"):
        fused_ce.fused_cross_entropy(x, lab, torch.ones(C - 1))
    with pytest.raises(ValueError, match="classes"):
        fused_ce.fused_cross_entropy(torch.zeros(4, 40), torch.zeros(
            4, dtype=torch.int32))
    with pytest.raises(ValueError, match="no fused_ce kernel"):
        fused_ce.FusedCrossEntropyFn.apply(
            x.reshape(-1, C).to("meta"), lab.reshape(-1).to("meta"),
            torch.ones(C, device="meta"))


def _update_err(after, want, start, names):
    """Largest difference of two steps' parameter updates, each relative to
    the reference update's largest element, floored at 1e-3 of the largest
    update of any parameter (the conv biases ahead of a train-mode BN get
    gradients of rounding size only)."""
    upd = {k: want[k] - start[k] for k in names}
    top = max(float(u.abs().max()) for u in upd.values())
    return max(float((after[k] - start[k] - u).abs().max())
               / max(float(u.abs().max()), 1e-3 * top)
               for k, u in upd.items())


def test_fused_ce_train_step_equals_eager_wcel():
    """One f32 Unetv2 step through ``build_fused_ce`` and one through the
    eager wCEL from the same weights and batch, then the validation loss
    of each under ``inference_mode``. One SGD2 step moves a parameter by
    about 1e-5, so the parameters' updates are compared too, within 5e-2
    of the eager ones: a loss that passes half its gradient fails that."""
    rng = np.random.default_rng(3)
    image = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3))
                             .astype(np.uint8))
    mask = torch.from_numpy(rng.integers(0, C, (2, 32, 32)).astype(np.int32))
    weights = rng.uniform(0.5, 2.0, C).astype(np.float32)
    fused = fused_ce.build_fused_ce(weights, ignore_background=True,
                                    device="cpu")

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    runs = []
    for loss_fn in (fused, tlosses.build_loss("wCEL", weights=weights,
                                              ignore_background=True),
                    half_fused):
        model, _ = build_model("Unetv2", C, device="cpu", dtype=torch.float32)
        names = [k for k, _ in model.named_parameters()]
        start = {k: v.clone() for k, v in model.state_dict().items()}
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        state = TrainState(model, opt)
        loss = float(train_step(state, loss_fn, image, mask))
        val = float(loss_step(state, loss_fn, image, mask))
        runs.append((loss, val, model.state_dict()))
    (loss, val, got), (want, want_val, eager), (_, _, half) = runs
    assert abs(loss - want) <= 1e-6 * abs(want)
    assert abs(val - want_val) <= 1e-6 * abs(want_val)
    for k, v in eager.items():
        if v.is_floating_point():
            scale = max(1.0, float(v.abs().max()))
            assert float((got[k] - v).abs().max()) <= 1e-5 * scale, k
    assert _update_err(got, eager, start, names) <= 5e-2
    assert _update_err(half, eager, start, names) > 5e-2
