"""Asynchronous checkpoints and context windows on the card. Marked
``cuda``: on a machine without a card the tests skip. The file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_interop_cuda.py

* An asynchronous save of a SwinUnetTiny train state on the card, issued
  just before an SGD2 step that updates the parameters and the momentum
  buffers in place: the checkpoint holds the state as it was when the
  save was issued, bit for bit, and restores onto the card.
* ``extract_context`` and ``extract_resized`` on the card against the
  same functions on the CPU, on a two-scene stack at p 224 (3p windows,
  and crops of 448 and 300): masks equal, images within one level on at
  most 1% of the values (the card's and the CPU's f32 filters sum in
  different orders).
"""

import numpy as np
import pytest
import torch

from cvcs_tpu_torch.data import extract
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.ops.losses import build_loss
from cvcs_tpu_torch.train import checkpoint as ckpt_lib
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step
from _bounded import bounded_call

pytestmark = pytest.mark.cuda

P = 224
OFF_BY_ONE = 0.01


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(device, seed):
    model, _ = build_model("SwinUnetTiny", 16, device=device, seed=seed)
    return TrainState(model, build_optimizer("SGD2", model.parameters()))


def _step(state, device, seed):
    g = np.random.default_rng(seed)
    img = torch.from_numpy(g.integers(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)).to(device)
    msk = torch.from_numpy(g.integers(0, 16, (2, 64, 64)).astype(
        np.int32)).to(device)
    train_step(state, build_loss("CEL"), img, msk)


def test_async_snapshot_precedes_next_step(card, tmp_path):
    state = _state(card, 1)
    _step(state, card, 0)
    want_model = {k: v.cpu().clone() for k, v in
                  state.model.state_dict().items()}
    want_opt = {i: e["momentum_buffer"].cpu().clone() for i, e in
                state.optimizer.opt.state_dict()["state"].items()}
    path = ckpt_lib.save_checkpoint(tmp_path, 0, state, [1.0], [1.0], 2,
                                    "SGD2", async_save=True)
    _step(state, card, 1)              # in place, while the write runs
    bounded_call(ckpt_lib.wait_for_saves, 30)
    saved = torch.load(path / ckpt_lib.STATE, weights_only=True)
    assert all(torch.equal(saved["model"][k], v)
               for k, v in want_model.items())
    assert all(torch.equal(saved["optimizer"]["state"][i]["momentum_buffer"],
                           v) for i, v in want_opt.items())
    moved = state.model.state_dict()
    assert any(not torch.equal(moved[k].cpu(), v)
               for k, v in want_model.items())
    restored, _ = ckpt_lib.load_checkpoint(path, _state(card, 5))
    assert restored.step == 1
    assert all(torch.equal(restored.model.state_dict()[k].cpu(), v)
               for k, v in want_model.items())


def _scenes(seed):
    g = np.random.default_rng(seed)
    pad = P + 32
    images = g.integers(0, 256, (2, 1344 + 2 * pad, 1568 + 2 * pad, 3),
                        dtype=np.uint8)
    masks = g.integers(0, 16, images.shape[:3], dtype=np.uint8)
    return pad, torch.from_numpy(images), torch.from_numpy(masks), g


@pytest.mark.parametrize("size", [3 * P, 448, 300],
                         ids=["context", "tps448", "tps300"])
def test_extract_on_card_matches_cpu(card, size):
    pad, images, masks, g = _scenes(size)
    n = 64
    coords = torch.from_numpy(np.stack([
        g.integers(0, 2, n), g.integers(pad, 1344 + pad - size + P, n),
        g.integers(pad, 1568 + pad - size + P, n)], axis=1).astype(np.int32))
    if size == 3 * P:
        cpu = extract.extract_context(images, coords, P)
        dev = extract.extract_context(images.to(card), coords.to(card), P)
    else:
        cpu, cpu_m = extract.extract_resized(images, masks, coords, size, P)
        dev, dev_m = extract.extract_resized(images.to(card), masks.to(card),
                                             coords.to(card), size, P)
        assert torch.equal(dev_m.cpu(), cpu_m)
    assert dev.dtype == torch.uint8 and dev.shape == (n, P, P, 3)
    diff = (dev.cpu().int() - cpu.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= OFF_BY_ONE
