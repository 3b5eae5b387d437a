"""A Unetv2 train step on the card through the fused cross-entropy
kernels (K3 forward, K4 backward) against one through the eager wCEL,
from the same weights and batch. Marked ``cuda``: on a machine without a
card the test skips. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_unet_cuda.py

f32 with TF32 off on both sides, so only summation orders differ: loss
1e-5 relative, every parameter and BN running statistic within
1e-4 * max(1, |p|max), and each parameter's update within 5e-2 of the
eager step's update (relative to its largest element, floored at 1e-3 of
the largest update of any parameter). One SGD2 step moves a parameter
by about 1e-5, below the first tolerance, so the update check is the one
that sees the gradient: a step whose loss passes on half its gradient
fails it.
"""

import pytest
import torch

from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.ops import fused_ce, losses
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step

pytestmark = pytest.mark.cuda

C = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _update_err(after, want, start, names):
    upd = {k: want[k] - start[k] for k in names}
    top = max(float(u.abs().max()) for u in upd.values())
    return max(float((after[k] - start[k] - u).abs().max())
               / max(float(u.abs().max()), 1e-3 * top)
               for k, u in upd.items())


def test_unetv2_step_fused_loss_equals_eager(card):
    g = torch.Generator().manual_seed(0)
    image = torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                          dtype=torch.uint8).to(card)
    mask = torch.randint(0, C, (2, 64, 64), generator=g,
                         dtype=torch.int32).to(card)
    weights = torch.rand(C, generator=g) + 0.5
    fused = fused_ce.build_fused_ce(weights, ignore_background=True)

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    runs = []
    for loss_fn in (fused, losses.build_loss("wCEL", weights=weights,
                                             ignore_background=True,
                                             device=card), half_fused):
        model, _ = build_model("Unetv2", C, dtype=torch.float32)
        names = [k for k, _ in model.named_parameters()]
        start = {k: v.clone() for k, v in model.state_dict().items()}
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        f0, b0 = fused_ce.launches, fused_ce.bwd_launches
        loss = float(train_step(TrainState(model, opt), loss_fn, image, mask))
        runs.append((loss, model.state_dict(),
                     (fused_ce.launches - f0, fused_ce.bwd_launches - b0)))
    (loss, got, counts), (want, eager, eager_counts), (_, half, _) = runs
    assert counts == (1, 1) and eager_counts == (0, 0)
    assert abs(loss - want) <= 1e-5 * abs(want)
    for k, v in eager.items():
        if v.is_floating_point():
            scale = max(1.0, float(v.abs().max()))
            assert float((got[k] - v).abs().max()) <= 1e-4 * scale, k
    assert _update_err(got, eager, start, names) <= 5e-2
    assert _update_err(half, eager, start, names) > 5e-2
