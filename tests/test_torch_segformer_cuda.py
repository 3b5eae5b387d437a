"""SegformerMod (MiT-B3 at full width) on the card. Marked ``cuda``: on a
machine without a card the tests skip. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_segformer_cuda.py

* An f32 forward and an f32 train step (SGD2, the eager wCEL, seeded
  dropout) on the card against the same weights' on the CPU: logits
  within 1e-4 * max(1, |logits|max); the loss within 1e-5 relative and
  each parameter's update within 5e-2 of the CPU update (relative to its
  largest element, floored at 1e-3 of the largest update of any
  parameter): TF32 off on the card, so only summation orders differ. An
  update is taken as the step computes it, lr * (grad + wd * p), before
  it is rounded into the f32 parameter: many SegFormer updates are a few
  ulps of their parameter, too coarse to resolve 5e-2 of them. The
  dropout masks are given, the same on both devices: the card's
  generator draws other numbers than the CPU's for one seed.
* Seeded dropout on the card: one (seed, step) gives one mask, another
  step another.
* A train step through ``build_fused_ce`` (K3 forward, K4 backward)
  against one through the eager wCEL, from the same weights, batch and
  dropout seed: loss 1e-5 relative, each update within 5e-2 of the
  eager one's; a loss passing half its gradient fails that bound.
"""

import pytest
import torch

from cvcs_tpu_torch.models import blocks, build_model
from cvcs_tpu_torch.ops import fused_ce, losses
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step

pytestmark = pytest.mark.cuda

C = 16
P, BATCH = 64, 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    image = torch.randint(0, 256, (BATCH, P, P, 3), generator=g,
                          dtype=torch.uint8)
    mask = torch.randint(0, C, (BATCH, P, P), generator=g, dtype=torch.int32)
    weights = torch.rand(C, generator=g) + 0.5
    return image, mask, weights


def _update_err(got, want):
    top = max(float(u.abs().max()) for u in want.values())
    return max(float((got[k] - u).abs().max())
               / max(float(u.abs().max()), 1e-3 * top)
               for k, u in want.items())


def _step(device, loss_fn, image, mask, keep=None, dropout_seed=0xD0):
    model, _ = build_model("SegformerMod", C, device=device, seed=0,
                           dtype=torch.float32)
    if keep is not None:
        model.decode_head.dropout.keep_mask = keep.to(device)
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt, dropout_seed=dropout_seed)
    loss = float(train_step(state, loss_fn, image.to(device),
                            mask.to(device)))
    group = opt.opt.param_groups[0]
    return loss, {k: group["lr"] * (p.grad.double() + group["weight_decay"]
                                    * p.detach().double()).cpu()
                  for k, p in model.named_parameters()}


def test_forward_and_step_match_cpu(card):
    image, mask, weights = _batch()
    cpu, _ = build_model("SegformerMod", C, device="cpu", seed=0,
                         dtype=torch.float32)
    gpu, _ = build_model("SegformerMod", C, seed=0, dtype=torch.float32)
    with torch.inference_mode():
        want = cpu(image.float())
        got = gpu(image.to(card).float()).cpu()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale

    keep = torch.rand(BATCH, P // 4, P // 4, 768,
                      generator=torch.Generator().manual_seed(1)) < 0.9

    def wcel(device):
        return losses.build_loss("wCEL", weights=weights,
                                 ignore_background=True, device=device)

    c_loss, c_upd = _step("cpu", wcel("cpu"), image, mask, keep)
    g_loss, g_upd = _step(card, wcel(card), image, mask, keep)
    assert abs(g_loss - c_loss) <= 1e-5 * abs(c_loss)
    assert _update_err(g_upd, c_upd) <= 5e-2


def test_dropout_draws_repeat(card):
    drop = blocks.SeededDropout(0.1).train()
    x = torch.ones(10, 56, 56, 768, device=card)
    draws = []
    for step in (3, 3, 4):
        blocks.seed_dropout(drop, 0xD0, step)
        draws.append(drop(x))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    kept = float((draws[0] != 0).float().mean())
    assert 0.895 < kept < 0.905


def test_fused_ce_step_equals_eager(card):
    image, mask, weights = _batch(2)
    fused = fused_ce.build_fused_ce(weights, ignore_background=True)
    eager = losses.build_loss("wCEL", weights=weights,
                              ignore_background=True, device=card)

    def half_fused(logits, labels):        # same loss, half its gradient
        loss = fused(logits, labels)
        return 0.5 * loss + 0.5 * loss.detach()

    before = (fused_ce.launches, fused_ce.bwd_launches)
    f_loss, f_upd = _step(card, fused, image, mask)
    assert (fused_ce.launches - before[0],
            fused_ce.bwd_launches - before[1]) == (1, 1)
    e_loss, e_upd = _step(card, eager, image, mask)
    h_loss, h_upd = _step(card, half_fused, image, mask)
    assert abs(f_loss - e_loss) <= 1e-5 * abs(e_loss)
    assert _update_err(f_upd, e_upd) <= 5e-2
    assert h_loss == f_loss
    assert _update_err(h_upd, e_upd) > 5e-2
