"""The fused weighted cross-entropy kernels against their plain versions,
on the card: K3 (forward sums) and K4 (backward) of ``csrc/fused_ce.cu``.
Marked ``cuda``: on a machine without a card every test skips.

The file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_fused_ce_cuda.py

Shapes: the Unetv2 recipe step's logits, 10 x 224 x 224 x 16 f32, with
about 30% class-0 labels under ``ignore_index`` 0, 1% label 255 and class
weights; and a ragged N (2 x 37 x 41) that is not a multiple of the block
size, with labels -1 and 255 and no class ignored. Tolerances: loss_sum,
wsum and the loss 1e-5 relative (both in f32, only the summation order
differs); dlogits 1e-5 * max(1, |plain|max) and, because dlogits of a
mean over 5e5 pixels are ~1e-6, 1e-5 * |plain|max. Two K3 runs are
bit-equal (no atomics).
"""

import pytest
import torch

from cvcs_tpu_torch.ops import fused_ce

pytestmark = pytest.mark.cuda

C = 16
SHAPES = {"step": (10, 224, 224), "ragged": (2, 37, 41)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(shape, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(*shape, C, generator=g) * 3
    labels = torch.randint(1, C, shape, generator=g, dtype=torch.int32)
    u = torch.rand(shape, generator=g)
    labels[u < 0.3] = 0
    labels[u > 0.99] = 255
    labels.view(-1)[:3] = torch.tensor([-1, 255, 0], dtype=torch.int32)
    weights = torch.rand(C, generator=g) + 0.5
    ignore = 0 if shape == SHAPES["step"] else None
    w = fused_ce.effective_weights(weights, C, ignore, device)
    return (logits.reshape(-1, C).to(device), labels.reshape(-1).to(device),
            w)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_forward_kernel_matches_plain(card, shape):
    x, lab, w = _inputs(SHAPES[shape], card)
    before = fused_ce.launches
    loss_sum, wsum, loss = fused_ce._fwd_launch(x, lab, w)
    torch.cuda.synchronize()
    assert fused_ce.launches == before + 1
    want_sum, want_w = fused_ce.ce_sums_plain(x, lab, w)
    for got, want in ((loss_sum, want_sum), (wsum, want_w),
                      (loss, want_sum / want_w)):
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("shape", list(SHAPES))
def test_backward_kernel_matches_plain(card, shape):
    x, lab, w = _inputs(SHAPES[shape], card, seed=1)
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    g = torch.ones((), device=card)
    got = fused_ce._bwd_launch(x, lab, w, g, wsum)
    torch.cuda.synchronize()
    want = fused_ce.ce_grad_plain(x, lab, w, g / wsum.clamp(min=1e-12))
    err = float((got - want).abs().max())
    big = float(want.abs().max())
    assert err <= 1e-5 * max(1.0, big) and err <= 1e-5 * big
    dead = (lab < 0) | (lab >= C) | (w[lab.clamp(0, C - 1).long()] == 0)
    assert not got[dead].any()


def test_forward_kernel_repeats_bit_equal(card):
    x, lab, w = _inputs(SHAPES["step"], card, seed=2)
    first = [t.clone() for t in fused_ce._fwd_launch(x, lab, w)]
    for _ in range(3):
        again = fused_ce._fwd_launch(x, lab, w)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_autograd_op_launches_both_kernels(card):
    x, lab, w = _inputs(SHAPES["ragged"], card, seed=3)
    logits = x.reshape(2, 37, 41, C).clone().requires_grad_()
    f0, b0 = fused_ce.launches, fused_ce.bwd_launches
    loss = fused_ce.fused_cross_entropy(logits, lab.reshape(2, 37, 41),
                                        torch.ones(C, device=card), None)
    loss.backward()
    assert (fused_ce.launches - f0, fused_ce.bwd_launches - b0) == (1, 1)
    ref = logits.detach().cpu().requires_grad_()
    want = fused_ce.fused_cross_entropy(ref, lab.cpu().reshape(2, 37, 41))
    want.backward()
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    err = float((logits.grad.cpu() - ref.grad).abs().max())
    assert err <= 1e-5 * float(ref.grad.abs().max())
