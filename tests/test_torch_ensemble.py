"""The port's majority-vote Ensemble, on the CPU.

* ``Ensemble.vote`` equals ``cvcs_tpu.models.ensemble.Ensemble.vote`` on
  the same member label maps and logits, ties included: a 2-2 split and a
  1-1-1-1 split go to the smallest label (``torch.mode``'s rule).
* The member-count and ``None``-variables errors.
* ``cli.common.build_ensemble`` from a member map (the layout of
  ``configs/ensemble_test.yaml``) over two small members at p 32,
  SegformerB0 and MobileNet, each restored from a port checkpoint.
* ``cli.evaluate`` with ``net: Ensemble`` and ``device: cpu``: its
  confusion matrix is the one of the members' own predictions voted on
  the host with numpy, the first maximum winning.
* ``cli.predict`` takes ``net: Ensemble``; ``tta`` is refused for it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from cvcs_tpu.models.ensemble import Ensemble as JaxEnsemble
from cvcs_tpu.models.ensemble import EnsembleMember as JaxMember
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import evaluate as tevaluate
from cvcs_tpu_torch.cli import predict as predict_cli
from cvcs_tpu_torch.data.loader import ChunkLoader
from cvcs_tpu_torch.metrics import scores
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.models.ensemble import Ensemble, EnsembleMember
from cvcs_tpu_torch.train.checkpoint import save_checkpoint
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from test_torch_evaluate import _recorded, write_scenes

NUM_CLASSES = 16
P = 32
MEMBERS = {"SegformerB0": 1, "MobileNet": 2}       # net -> init seed


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _label_maps() -> np.ndarray:
    """Four members' (1, 2, 3) label maps: pixel 0 a 3-1 majority, pixel
    1 a 2-2 tie (5 and 2 -> 2), pixel 2 a 1-1-1-1 split (-> 3)."""
    maps = np.zeros((4, 1, 2, 3), np.int32)
    maps[:, 0, 0, 0] = (7, 7, 7, 1)
    maps[:, 0, 0, 1] = (5, 2, 5, 2)
    maps[:, 0, 0, 2] = (9, 3, 12, 4)
    maps[:, 0, 1] = np.random.default_rng(0).integers(0, NUM_CLASSES, (4, 3))
    return maps


def test_vote_matches_jax_ties_included():
    maps = _label_maps()
    logits = np.random.default_rng(1).normal(
        size=(1, 2, 3, NUM_CLASSES)).astype(np.float32)
    image = np.zeros((1, 2, 3, 3), np.float32)
    jmembers = [JaxMember(f"m{i}", lambda img, ctx, m=m: jnp.asarray(m),
                          returns_logits=False) for i, m in enumerate(maps)]
    jmembers.append(JaxMember("logits", lambda img, ctx: jnp.asarray(logits)))
    want = np.asarray(JaxEnsemble(jmembers, NUM_CLASSES)(jnp.asarray(image)))
    members = [EnsembleMember(f"m{i}", lambda img, m=m: torch.from_numpy(m),
                              returns_logits=False)
               for i, m in enumerate(maps)]
    members.append(EnsembleMember("logits",
                                  lambda img: torch.from_numpy(logits)))
    got = Ensemble(members, NUM_CLASSES)(torch.from_numpy(image))
    assert got.dtype == torch.int32 and got.shape == (1, 2, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # the four label maps alone: the tie rules themselves
    alone = Ensemble(members[:4], NUM_CLASSES)(torch.from_numpy(image))
    assert alone[0, 0].tolist() == [7, 2, 3]


def test_vote_errors():
    with pytest.raises(ValueError, match="at least one member"):
        Ensemble([], NUM_CLASSES)
    maps = _label_maps()
    image = torch.zeros(1, 2, 3, 3)
    closure = EnsembleMember("a", lambda img: torch.from_numpy(maps[0]),
                             returns_logits=False)
    held = EnsembleMember("b", lambda v, img: torch.from_numpy(v),
                          returns_logits=False, variables=maps[1])
    ens = Ensemble([closure, held], NUM_CLASSES)
    assert ens.returns_logits is False and ens.wrapper is True
    assert ens.vote([None, maps[2]], image).shape == (1, 2, 3)
    with pytest.raises(ValueError, match="zip-truncation"):
        ens.vote([None], image)
    with pytest.raises(ValueError, match="entry is None"):
        ens.vote([None, None], image)


@pytest.fixture(scope="module")
def member_map(tmp_path_factory):
    """Port checkpoints of two members (random weights, distinct seeds)
    and the member map that names them; the members' own models."""
    root = tmp_path_factory.mktemp("ensemble")
    entries, models = {}, {}
    for name, seed in MEMBERS.items():
        model, _ = build_model(name, NUM_CLASSES, device="cpu", seed=seed,
                               dtype=torch.float32)
        state = TrainState(model, build_optimizer("SGD2", model.parameters()))
        entries[name] = str(save_checkpoint(root / name, 0, state, [], [], 2,
                                            "SGD2"))
        models[name] = model
    path = root / "members.yaml"
    path.write_text(yaml.safe_dump(entries, sort_keys=False))
    return str(path), models


def test_build_ensemble_restores_members(member_map):
    path, models = member_map
    ens = common.build_ensemble(dict(ensemble_config=path, precision="f32"),
                                "cpu")
    assert [m.name for m in ens.members] == list(MEMBERS)
    for m in ens.members:
        assert not m.apply.training and m.returns_logits
        want = models[m.name].state_dict()
        for k, v in m.apply.state_dict().items():
            assert torch.equal(v, want[k]), (m.name, k)
    with pytest.raises(ValueError, match="ensemble_config"):
        common.build_ensemble({}, "cpu")


def _host_vote(preds: list) -> np.ndarray:
    """numpy one-hot counts and argmax (the first maximum)."""
    counts = sum(np.eye(NUM_CLASSES, dtype=np.int32)[p] for p in preds)
    return counts.argmax(-1)


def test_evaluate_ensemble_matches_host_vote(tmp_path, monkeypatch,
                                             member_map):
    path, models = member_map
    cfg = dict(dataset=write_scenes(tmp_path / "set", 2, seed=13, h=64,
                                    w=96),
               net="Ensemble", ensemble_config=path, patch_size=P,
               num_classes=15, precision="f32", ignore_background=True,
               batch_size=5, device="cpu")
    confs: list = []
    _recorded(monkeypatch, scores, confs)
    tevaluate.evaluate(cfg)

    loader = ChunkLoader(cfg["dataset"], chunk_size=1, patch_size=P, seed=0,
                         device="cpu")
    want = np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
    for c in range(len(loader)):
        chunk = loader.get_chunk(c, shuffle_patches=False)
        with torch.no_grad():
            preds = [models[name](chunk.images.float()).argmax(-1).numpy()
                     for name in MEMBERS]
        label = _host_vote(preds).reshape(-1)
        target = chunk.masks.numpy().reshape(-1)
        keep = (target > 0) & (target < NUM_CLASSES)
        np.add.at(want, (target[keep], label[keep]), 1)
    assert want.sum() > 0
    np.testing.assert_array_equal(confs[0], want)


def test_predict_takes_the_ensemble(tmp_path, member_map):
    path, _ = member_map
    cfg = dict(dataset=write_scenes(tmp_path / "set", 1, seed=14, h=64,
                                    w=64),
               net="Ensemble", ensemble_config=path, patch_size=P,
               border_correction=48, num_classes=15, precision="f32",
               device="cpu", mask_only=True, output=str(tmp_path / "out"),
               out_image=str(tmp_path / "map.png"))
    predict_cli.predict(cfg)
    assert sorted(int(p.stem) for p in (tmp_path / "out").glob("*.png")) \
        == [0, 1, 2, 3]
    assert Image.open(tmp_path / "map.png").size == (64, 64)
    with pytest.raises(ValueError, match="tta"):
        predict_cli.predict(dict(cfg, tta=True))
