"""Retrieval on the card. Marked ``cuda``: on a machine without a card the
tests skip. The file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_retrieval_cuda.py

* The mask scores of a probe against a pool of 96 blocky 224 x 224
  masks on the card against the same masks' on the CPU: within 1e-6
  absolute (counts are integers, ratios one correctly rounded division,
  class sums in class order, so the bits should agree).
* f32 CLS embeddings of ``vits16`` and ``vitb8`` (full width and depth,
  seeded random weights) of 4 patches, and the f32 tap embeddings of
  MobileNet (960-d, max pool) and Unetv2 (x5, 1024-d), on the card
  against the CPU: within 1e-4 * max(1, |CPU|max), TF32 off (only
  summation orders differ). A bf16 ``vitb8`` forward on the card is
  finite and within 5e-2 of scale of its f32 one.
"""

import pytest
import torch

from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.models.vit import VIT_VARIANTS, ViT, dino_vit
from cvcs_tpu_torch.retrieval.features import extract_embedding
from cvcs_tpu_torch.retrieval.scores import SCORE_NAMES, compute_scores

pytestmark = pytest.mark.cuda

C = 16
P = 224
TOL_EMBED = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _images(n: int = 4, seed: int = 0) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, P, P, 3), generator=g,
                         dtype=torch.uint8)


def _close(got: torch.Tensor, want: torch.Tensor, tol: float) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= tol * scale, (err, scale)


def test_scores_on_the_card_equal_the_cpu(card):
    g = torch.Generator().manual_seed(1)
    blocks = torch.randint(0, C, (96, P // 32, P // 32), generator=g)
    masks = blocks.repeat_interleave(32, 1).repeat_interleave(32, 2)
    masks = masks.to(torch.uint8)
    masks[::7] = 0                              # all-background masks
    for probe in (0, 3, 50):
        want = compute_scores(masks[probe], masks, C)
        dev = masks.to(card)
        got = compute_scores(dev[probe], dev, C)
        for k in SCORE_NAMES:
            err = float((got[k].cpu() - want[k]).abs().max())
            assert err <= 1e-6, (k, err)


@pytest.mark.parametrize("variant", ["vits16", "vitb8"])
def test_vit_embeddings_on_the_card_match_the_cpu(card, variant):
    weights = dino_vit(variant).state_dict()
    x = (_images().float() / 255.0 - 0.45) / 0.225
    cpu = ViT(**VIT_VARIANTS[variant], dtype=torch.float32)
    cpu.load_state_dict(weights)
    on_card = ViT(**VIT_VARIANTS[variant], dtype=torch.float32).to(card)
    on_card.load_state_dict(weights)
    with torch.no_grad():
        want, _ = cpu(x)
        got, tokens = on_card(x.to(card))
    assert got.shape == (4, cpu.dim) and tokens.device.type == "cuda"
    _close(got, want, TOL_EMBED)
    if variant == "vitb8":
        bf16 = ViT(**VIT_VARIANTS[variant]).to(card)
        bf16.load_state_dict(weights)
        with torch.no_grad():
            low, _ = bf16(x.to(card))
        assert torch.isfinite(low).all()
        _close(low, got, 5e-2)


@pytest.mark.parametrize("name,dim", [("MobileNet", 960), ("Unetv2", 1024)])
def test_tap_embeddings_on_the_card_match_the_cpu(card, name, dim):
    cpu, _ = build_model(name, C, device="cpu", dtype=torch.float32)
    on_card, _ = build_model(name, C, device=card, dtype=torch.float32)
    images = _images(2, seed=3)
    want = extract_embedding(cpu, images)
    got = extract_embedding(on_card, images.to(card))
    assert got.shape == (2, dim)
    _close(got, want, TOL_EMBED)
