"""The DeepLab family on the card. Marked ``cuda``: on a machine without a
card the tests skip. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_deeplab_cuda.py

* Each of the five DeepLab names (random weights, seed 0) at p 64, batch
  2: the f32 eval logits on the card against the same weights on the
  CPU, within 1e-4 * max(1, |CPU logits|max), with cuDNN's deterministic
  algorithms and TF32 off: only summation orders differ. This holds
  cuDNN's dilated (ResNet stages 3-4, ASPP), depthwise and grouped
  (MobileNet) and ceil-mode pooling (GoogLeNet) paths to the CPU's.
* An f32 Resnet101 train step through ``build_fused_ce`` (K3 forward, K4
  backward) against one through the eager wCEL, from the same weights,
  batch and dropout seed: loss 1e-5 relative, each parameter's update
  (lr * (grad + wd * p), before it is rounded into the parameter) within
  5e-2 of the eager one's, relative to its largest element and floored
  at 1e-3 of the largest update of any parameter; a loss passing half its
  gradient fails that bound.
"""

import copy

import pytest
import torch

from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.ops import fused_ce, losses
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step

pytestmark = pytest.mark.cuda

C = 16
P, BATCH = 64, 2
NAMES = ("Resnet101", "Resnet50", "MobileNet", "MobileNetGoogle",
         "MobileNetResnet18")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = False


def _batch(seed=0):
    g = torch.Generator().manual_seed(seed)
    image = torch.randint(0, 256, (BATCH, P, P, 3), generator=g,
                          dtype=torch.uint8)
    mask = torch.randint(0, C, (BATCH, P, P), generator=g, dtype=torch.int32)
    weights = torch.rand(C, generator=g) + 0.5
    weights[0] = 0.0
    return image, mask, weights


@pytest.mark.parametrize("name", NAMES)
def test_f32_logits_match_cpu(card, name):
    image, _, _ = _batch()
    cpu, _ = build_model(name, C, device="cpu", seed=0, dtype=torch.float32)
    gpu = copy.deepcopy(cpu).to(card)
    with torch.inference_mode():
        want = cpu(image.float())
        got = gpu(image.to(card).float()).cpu()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-4 * scale


def _update_err(got, want):
    top = max(float(u.abs().max()) for u in want.values())
    return max(float((got[k] - u).abs().max())
               / max(float(u.abs().max()), 1e-3 * top)
               for k, u in want.items())


def _step(device, loss_fn, image, mask):
    model, _ = build_model("Resnet101", C, device=device, seed=0,
                           dtype=torch.float32)
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    loss = float(train_step(state, loss_fn, image.to(device),
                            mask.to(device)))
    group = opt.opt.param_groups[0]
    return loss, {k: group["lr"] * (p.grad.double() + group["weight_decay"]
                                    * p.detach().double()).cpu()
                  for k, p in model.named_parameters()}


def test_resnet101_fused_ce_step_equals_eager(card):
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
