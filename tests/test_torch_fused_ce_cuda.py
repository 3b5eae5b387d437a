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

K4's edges (``EDGES``), at the same tolerances: class counts 16, 15, 7,
32 and 1 (the float4 lane groups and the one-float-per-lane path), a
ragged N and N = 0, logits and dlogits at an offset that breaks 16-byte
alignment, every row of weight 0, labels 255 and -1; and three K4 runs
bit-equal.
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


# (C, N): K4's lane groups (C / 4 = 4, 8 lanes; C off 4: one float a lane,
# 16, 8, 1 lanes), a ragged N
EDGES = {"c16": (16, 4099), "c15": (15, 4099), "c7": (7, 1037),
         "c32": (32, 2053), "c1": (1, 999), "c16_n1": (16, 1)}


def _edge_inputs(c, n, device, seed):
    """(N, C) logits, labels with -1 and 255 among classes 0..C-1, the
    class weights with class 0 ignored (when C > 1)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(n, c, generator=g) * 3
    labels = torch.randint(0, c, (n,), generator=g, dtype=torch.int32)
    u = torch.rand(n, generator=g)
    labels[u < 0.02] = -1
    labels[u > 0.98] = 255
    w = fused_ce.effective_weights(torch.rand(c, generator=g) + 0.5, c,
                                   0 if c > 1 else None, device)
    return logits.to(device), labels.to(device), w


def _bwd_into(x, lab, w, g, wsum, out):
    """K4 through its C entry point, into a caller's (N, C) ``out``."""
    _, bwd, _ = fused_ce._kernels()
    n, c = x.shape
    rc = bwd(x.data_ptr(), lab.data_ptr(), w.data_ptr(), g.data_ptr(),
             wsum.data_ptr(), out.data_ptr(), n, c,
             torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    torch.cuda.synchronize()


def _assert_grad_close(got, x, lab, w, g, wsum):
    want = fused_ce.ce_grad_plain(x, lab, w, g / wsum.clamp(min=1e-12))
    err = float((got - want).abs().max()) if want.numel() else 0.0
    big = float(want.abs().max()) if want.numel() else 0.0
    assert err <= 1e-5 * max(1.0, big) and err <= 1e-5 * big, (err, big)
    c = x.shape[1]
    dead = (lab < 0) | (lab >= c) | (w[lab.clamp(0, c - 1).long()] == 0)
    assert not got[dead].any()


@pytest.mark.parametrize("edge", list(EDGES))
def test_backward_kernel_edges(card, edge):
    c, n = EDGES[edge]
    x, lab, w = _edge_inputs(c, n, card, seed=n + c)
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    g = torch.full((), 0.75, device=card)
    before = fused_ce.bwd_launches
    got = fused_ce._bwd_launch(x, lab, w, g, wsum)
    torch.cuda.synchronize()
    assert fused_ce.bwd_launches == before + 1
    assert got.shape == (n, c) and got.dtype == torch.float32
    _assert_grad_close(got, x, lab, w, g, wsum)


@pytest.mark.parametrize("c", [16, 15])
def test_backward_kernel_unaligned(card, c):
    """Logits and dlogits 4 bytes past a 16-byte boundary: the kernel
    takes its one-float-per-lane path and still agrees."""
    n = 3001
    x, lab, w = _edge_inputs(c, n, card, seed=7 + c)
    xs = torch.empty(n * c + 1, device=card)[1:].view(n, c)
    xs.copy_(x)
    out = torch.full((n * c + 1,), float("nan"), device=card)[1:].view(n, c)
    assert xs.data_ptr() % 16 and out.data_ptr() % 16
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    g = torch.ones((), device=card)
    _bwd_into(xs, lab, w, g, wsum, out)
    _assert_grad_close(out, x, lab, w, g, wsum)


def test_backward_kernel_all_weight_zero(card):
    """Every label ignored or void: sum w is 0 and every row is zero."""
    x, lab, w = _edge_inputs(16, 2000, card, seed=11)
    lab = torch.where(torch.arange(2000, device=card) % 2 == 0, 0, 255)
    lab = lab.to(torch.int32)
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    assert float(wsum) == 0.0
    got = fused_ce._bwd_launch(x, lab, w, torch.ones((), device=card), wsum)
    torch.cuda.synchronize()
    assert not got.any()


def test_backward_kernel_empty(card):
    x = torch.empty((0, 16), device=card)
    lab = torch.empty((0,), dtype=torch.int32, device=card)
    w = torch.ones(16, device=card)
    wsum = torch.zeros((), device=card)
    before = fused_ce.bwd_launches
    got = fused_ce._bwd_launch(x, lab, w, torch.ones((), device=card), wsum)
    torch.cuda.synchronize()
    assert got.shape == (0, 16)
    assert fused_ce.bwd_launches == before      # nothing to launch


def test_backward_kernel_repeats_bit_equal(card):
    x, lab, w = _inputs(SHAPES["step"], card, seed=4)
    _, wsum, _ = fused_ce._fwd_launch(x, lab, w)
    g = torch.ones((), device=card)
    first = fused_ce._bwd_launch(x, lab, w, g, wsum).clone()
    for _ in range(3):
        assert torch.equal(fused_ce._bwd_launch(x, lab, w, g, wsum), first)
