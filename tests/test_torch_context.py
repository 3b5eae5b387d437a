"""Context windows and ``random_tps`` crops of the port against the JAX
package's, on the CPU, from the same numpy inputs and draws.

* ``extract_context`` (3p -> p, a 3:1 resize) and ``extract_resized``
  (crops of 2p -> p and of 40 -> 32, a ratio that is not a whole number):
  masks equal; images within one level, on at most ``OFF_BY_ONE`` of the
  values (the two frameworks' f32 filters sum in different orders, so a
  value next to a .5 can round the other way: 0.040%, 0.0036% and 0.22%
  of them did when this was written).
* ``ChunkLoader`` with ``load_context``, ``random_shift`` and two
  ``random_tps`` entries, augmentation off, one seed: two epochs of
  chunks (the scene shuffle, the shifts, each entry's scene, row and
  column draws, the permutation) hold the same patches, masks and
  contexts as JAX's, by the same rule; the context and shift paddings
  add, so the corner tiles' windows reach into the zero border as JAX's
  do; a crop as large as the scene is refused by both.
* A toy net whose spec sets ``requires_context`` is trained, validated
  and evaluated by the ``Trainer``: each call receives the f32 context
  windows of its own patches, in the chunk's order; a net without the
  flag receives none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.data import extract as jextract
from cvcs_tpu.data.loader import ChunkLoader as JaxChunkLoader
from cvcs_tpu_torch.data import extract
from cvcs_tpu_torch.data.loader import SHIFT_OFFSET, ChunkLoader
from cvcs_tpu_torch.models.registry import ModelSpec
from cvcs_tpu_torch.ops.losses import build_loss
from cvcs_tpu_torch.train.loop import TrainConfig, Trainer
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState

OFF_BY_ONE = 0.01          # share of image values one level apart, at most
P = 32
TPS = [[64, 0.25], [40, 0.5]]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near(got: torch.Tensor, want, what: str) -> float:
    """Images within one level; returns the share of values that differ."""
    got = got.numpy().astype(np.int32)
    want = np.asarray(want).astype(np.int32)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    assert diff.max() <= 1, what
    share = float((diff > 0).mean())
    assert share <= OFF_BY_ONE, (what, share)
    return share


@pytest.mark.parametrize("kind,size", [("context", 3 * P),
                                       ("resized", 2 * P),
                                       ("resized", 40)],
                         ids=["context_3to1", "tps_2to1", "tps_40to32"])
def test_extract_matches_jax(kind, size):
    rng = np.random.default_rng(size)
    pad = P
    scenes = rng.integers(0, 256, (2, 160 + 2 * pad, 192 + 2 * pad, 3),
                          dtype=np.uint8)
    masks = rng.integers(0, 16, scenes.shape[:3], dtype=np.uint8)
    coords = np.stack([rng.integers(0, 2, 9),
                       rng.integers(pad, 160 + pad - size, 9),
                       rng.integers(pad, 192 + pad - size, 9)],
                      axis=1).astype(np.int32)
    ts, tm, tc = (torch.from_numpy(a) for a in (scenes, masks, coords))
    if kind == "context":
        got = extract.extract_context(ts, tc, P)
        want = jextract.extract_context(jnp.asarray(scenes),
                                        jnp.asarray(coords), P)
    else:
        got, got_m = extract.extract_resized(ts, tm, tc, size, P)
        want, want_m = jextract.extract_resized(
            jnp.asarray(scenes), jnp.asarray(masks), jnp.asarray(coords),
            size, P)
        assert got_m.dtype == torch.uint8
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got.dtype == torch.uint8 and got.shape == (9, P, P, 3)
    _near(got, want, kind)


def test_chunk_loader_matches_jax(gid15_root):
    kw = dict(chunk_size=2, patch_size=P, random_shift=True,
              load_context=True, seed=11)
    jl = JaxChunkLoader(str(gid15_root), **kw)
    tl = ChunkLoader(str(gid15_root), device="cpu", **kw)
    assert tl._pad() == jl._pad() == P + SHIFT_OFFSET + 12
    tiles = 2 * tl.tpi
    n = tiles + sum(int(share * tiles) for _, share in TPS)
    for _ in range(2):
        jl.shuffle()
        tl.shuffle()
        assert tl.chunks == jl.chunks
        for c in range(len(jl)):
            want, got = jl.get_chunk(c, TPS), tl.get_chunk(c, TPS)
            assert len(got) == len(want) == n
            assert got.contexts.dtype == torch.uint8
            np.testing.assert_array_equal(got.masks.numpy(),
                                          np.asarray(want.masks))
            _near(got.images, want.images, f"chunk {c} patches")
            _near(got.contexts, want.contexts, f"chunk {c} contexts")
    # in order: the tiles first, equal (a plain gather), the corner
    # tile's context reading the zero border
    want = jl.get_chunk(0, shuffle_patches=False)
    got = tl.get_chunk(0, shuffle_patches=False)
    np.testing.assert_array_equal(got.images.numpy(),
                                  np.asarray(want.images))
    _near(got.contexts, want.contexts, "unshuffled contexts")
    assert got.contexts[0, :P // 4, :P // 4].max() == 0
    with pytest.raises(ValueError, match="smaller than the scene"):
        tl.get_chunk(0, [[96, 0.5]])
    with pytest.raises(ValueError, match="smaller than the scene"):
        jl.get_chunk(0, [[96, 0.5]])


class ContextNet(torch.nn.Module):
    """Logits from the image and its context; records the contexts it is
    given."""

    def __init__(self):
        super().__init__()
        self.head = torch.nn.Linear(6, 16)
        self.seen = []

    def forward(self, x, context=None):
        self.seen.append(context)
        if context is None:
            context = torch.zeros_like(x)
        return self.head(torch.cat([x, context], -1) / 255.0)


@pytest.mark.parametrize("requires_context", [True, False])
def test_context_reaches_net_that_reads_it(gid15_root, tmp_path,
                                           requires_context):
    def loader(seed, shift):
        return ChunkLoader(str(gid15_root), chunk_size=2, patch_size=P,
                           load_context=True, random_shift=shift, seed=seed,
                           device="cpu")

    train, val = loader(3, True), loader(4, False)
    train.specify([0, 1])
    val.specify([0])
    chunks = []
    get_chunk = train.get_chunk

    def recording(c, random_tps=None, **kw):
        chunks.append(get_chunk(c, random_tps, **kw))
        return chunks[-1]

    train.get_chunk = recording
    model = ContextNet()
    spec = ModelSpec("ContextNet", ContextNet,
                     requires_context=requires_context)
    state = TrainState(model, build_optimizer("SGD2", model.parameters()))
    cfg = TrainConfig(epochs=1, batch_size=10, checkpoint_directory=str(
        tmp_path), precision_evaluation_freq=1, random_tps=[[48, 0.25]])
    trainer = Trainer(spec, state, build_loss("CEL"), train, val, cfg,
                      log=lambda s: None)
    trainer.train()
    (chunk,) = chunks
    assert len(chunk) == 24 + 6
    n_train = -(-len(chunk) // 10)                 # 3 steps, the last of 10
    seen = model.seen
    if not requires_context:
        assert all(s is None for s in seen)
        return
    assert all(s is not None and s.dtype == torch.float32 for s in seen)
    torch.testing.assert_close(torch.cat(seen[:n_train]),
                               chunk.contexts.float(), rtol=0, atol=0)
    # validation loss (batches of 10) and evaluation (batches of 8, the
    # tail padded) read the validation scene's contexts in order
    ctx = val.get_chunk(0, shuffle_patches=False).contexts.float()
    torch.testing.assert_close(torch.cat(seen[n_train:n_train + 2]), ctx,
                               rtol=0, atol=0)
    evaluated = torch.cat(seen[n_train + 2:])
    torch.testing.assert_close(evaluated[:12], ctx, rtol=0, atol=0)
