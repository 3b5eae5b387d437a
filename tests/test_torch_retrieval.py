"""The port's retrieval library (``cvcs_tpu_torch.retrieval``) against the
JAX package's (``cvcs_tpu.retrieval``), on the CPU, from the same numpy
masks, images and weights.

* Mask scores: ``compute_scores`` and each score function over several
  seeds of blocky masks (many equal scores), and the edge cases: classes
  absent from the target, an all-background target, all-background
  queries, identical masks. f32, within 1e-6 absolute (the scores lie in
  [0, 1], EMD in [0, 14]). Every count is an integer, each ratio one
  division, and the sums over the classes add in XLA's order, so on
  these inputs the port's scores are JAX's bit for bit; the tolerance
  leaves room for another XLA build.
* Rankings: ``rank_candidates`` of the port's scores against JAX's
  ranking of JAX's scores under the tie rule below;
  ``get_best_match_idx``, ``scores_evaluation`` and ``rank_by_distance``
  equal JAX's.
* Embedding taps: Unet (x5, 1024 planes) at p 32, SegformerB0 (the last
  MiT stage) and MobileNet (the DeepLab backbone's 960 planes) with the
  JAX variables carried across, f32, max and mean pools against JAX's
  ``extract_embedding`` within 1e-4 * max(1, |ref|max) (summation orders
  of the convolutions differ); nets without a tap raise in both.

The tie rule: split JAX's full ranking into runs of neighbours whose JAX
scores differ by at most ``TOL`` (1e-6). The port's ranking must hold,
at every position, a candidate of the same run as JAX's ranking holds
there: equal where neighbouring scores differ by more than the tolerance,
equal as sets within a run of ties (a run cut by ``topk`` gives members
of that run).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu.retrieval import features as jfeat
from cvcs_tpu.retrieval import scores as jscores
from cvcs_tpu_torch.models import registry as tregistry
from cvcs_tpu_torch.retrieval import features as tfeat
from cvcs_tpu_torch.retrieval import scores as tscores
from cvcs_tpu_torch.weights import load_jax_variables
from test_torch_segformer import _close, _numpy_variables

C = 16
TOL = 1e-6
TOL_TAP = 1e-4
SCORES = ("miou", "wiou", "pprec", "emd")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tie_runs(order, values, tol: float = TOL) -> dict:
    """Candidate id -> index of its run in the reference ranking
    ``order``: a new run starts where neighbouring reference scores
    differ by more than ``tol``."""
    runs, run = {}, 0
    for i, k in enumerate(order):
        if i and abs(float(values[k]) - float(values[order[i - 1]])) > tol:
            run += 1
        runs[int(k)] = run
    return runs


def assert_same_ranking(got, want, runs: dict) -> None:
    """The tie rule: position by position, the same run."""
    got, want = [int(k) for k in got], [int(k) for k in want]
    assert len(got) == len(want) and len(set(got)) == len(got)
    assert [runs[k] for k in got] == [runs[k] for k in want], (got, want)


def _masks(seed: int, batch: int = 24, side: int = 32,
           classes=range(C)) -> np.ndarray:
    """Blocky masks (4 x 4 blocks) over ``classes``."""
    rng = np.random.default_rng(seed)
    blocks = rng.choice(np.asarray(list(classes)),
                        (batch, side // 4, side // 4))
    return np.kron(blocks, np.ones((1, 4, 4), np.int64)).astype(np.int32)


def _tied_masks(seed: int, batch: int = 24) -> np.ndarray:
    """Masks from 6 prototypes: each a copy (every score ties) or a roll
    of its blocks (the same histogram: EMD ties), as synthetic scenes
    give."""
    rng = np.random.default_rng(seed)
    base = _masks(seed, batch=6, classes=(0, 1, 2, 5))
    pick = rng.integers(0, 6, batch)
    shift = 4 * rng.integers(0, 3, batch)
    return np.stack([np.roll(base[b], s, axis=1)
                     for b, s in zip(pick, shift)])


def _scores(target, queries):
    want = {k: np.asarray(v) for k, v in
            jscores.compute_scores(target, queries, C).items()}
    got = tscores.compute_scores(torch.from_numpy(target),
                                 torch.from_numpy(queries), C)
    return got, want


def _assert_scores(got, want):
    for k in SCORES:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0, atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_scores_match_jax(seed):
    q = _masks(seed, classes=range(0, C, 1 + seed % 3))
    _assert_scores(*_scores(q[seed], q))


def _edge_case(case: str):
    q = _masks(7)
    if case == "absent_classes":        # target holds classes 1-2 only
        t = _masks(8, batch=1, classes=(1, 2))[0]
        q[:6] = _masks(9, batch=6, classes=(0, 3, 4))
    elif case == "background_target":
        t = np.zeros_like(q[0])
    elif case == "background_queries":
        t = q[3].copy()
        q[::2] = 0
    else:                               # identical masks
        t = q[5].copy()
        q[[1, 2]] = t
    return t, q


@pytest.mark.parametrize("case", ["absent_classes", "background_target",
                                  "background_queries", "identical"])
def test_compute_scores_edge_cases_match_jax(case):
    t, q = _edge_case(case)
    got, want = _scores(t, q)
    _assert_scores(got, want)
    if case == "identical":
        for k, best in (("miou", 1.0), ("wiou", 1.0), ("pprec", 1.0),
                        ("emd", 0.0)):
            assert float(got[k][1]) == float(got[k][2]) == best, k


@pytest.mark.parametrize("name", ["per_image_miou", "per_image_wiou",
                                  "pixel_precision", "per_image_emd",
                                  "class_hist"])
def test_score_functions_match_jax(name):
    q = _masks(11)
    args = {"pixel_precision": (q[0], q), "class_hist": (q[4], C)}.get(
        name, (q[0], q, C))
    want = np.asarray(getattr(jscores, name)(*args))
    got = getattr(tscores, name)(*(torch.from_numpy(a)
                                   if isinstance(a, np.ndarray) else a
                                   for a in args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rankings_match_jax_under_the_tie_rule(seed):
    q = _tied_masks(seed)
    got, want = _scores(q[seed], q)
    for key, higher in (("emd", False), ("miou", True), ("wiou", True),
                        ("pprec", True)):
        order = jscores.rank_candidates(want[key], higher_better=higher)
        runs = tie_runs(order, want[key])
        assert len(set(runs.values())) < len(order), "no ties to test"
        assert_same_ranking(
            tscores.rank_candidates(got[key], higher_better=higher),
            order, runs)


def test_best_match_and_agreement_match_jax():
    q = _tied_masks(5)
    got, want = _scores(q[0], q)
    for key in SCORES:
        i = tscores.get_best_match_idx(key, got)
        j = jscores.get_best_match_idx(key, want)
        assert abs(want[key][i] - want[key][j]) <= TOL, key
    with pytest.raises(ValueError):
        tscores.get_best_match_idx("dice", got)
    rng = np.random.default_rng(0)
    emd = [list(rng.permutation(60)) for _ in range(7)]
    other = [list(rng.permutation(60)) for _ in range(7)]
    other[0][:5] = emd[0][:5]
    assert (tscores.scores_evaluation(emd, other, silent=True)
            == jscores.scores_evaluation(emd, other, silent=True))


@pytest.mark.parametrize("metric", ["l2", "l1", "cosine"])
def test_rank_by_distance_matches_jax(metric):
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((30, 8)).astype(np.float32)
    assert (tfeat.rank_by_distance(emb[4], emb, metric)
            == jfeat.rank_by_distance(emb[4], emb, metric))
    with pytest.raises(ValueError):
        tfeat.rank_by_distance(emb[0], emb, "dot")


# -- the embedding taps -------------------------------------------------------
TAP_NETS = ("Unet", "SegformerB0", "MobileNet")
P = 32


@pytest.fixture(scope="module")
def taps():
    """Per net: the JAX variables (numpy draws, nothing compiled for the
    init), the images, and JAX's max- and mean-pooled embeddings (one
    compiled tap forward each)."""
    images = np.random.default_rng(1).integers(
        0, 256, (2, P, P, 3)).astype(np.uint8)
    out = {}
    for name in TAP_NETS:
        model, _ = jax_build_model(name, C, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda m=model: m.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, P, P, 3)),
            train=False))
        v = _numpy_variables(shapes, seed=0)
        x = jnp.asarray(images)
        out[name] = dict(variables=v, images=images, **{
            pool: np.asarray(jfeat.extract_embedding(model, v, x, pool=pool))
            for pool in ("max", "mean")})
    return out


def _port_net(name: str, variables: dict):
    model = tregistry.MODEL_REGISTRY[name].build(C, dtype=torch.float32)
    return load_jax_variables(model, variables).eval()


@pytest.mark.parametrize("name", TAP_NETS)
def test_tap_embeddings_match_jax(taps, name):
    ref = taps[name]
    model = _port_net(name, ref["variables"])
    images = torch.from_numpy(ref["images"])
    feats = tfeat.extract_features(model, images)
    assert feats.dtype == torch.float32 and feats.dim() == 4
    assert feats.shape[-1] == {"Unet": 1024, "SegformerB0": 256,
                               "MobileNet": 960}[name]
    for pool in ("max", "mean"):
        got = tfeat.extract_embedding(model, images, pool=pool)
        assert got.shape == ref[pool].shape
        _close(got, ref[pool], TOL_TAP, f"{name} {pool}")
    with pytest.raises(ValueError):
        tfeat.extract_embedding(model, images, pool="sum")


def test_tap_stops_the_forward_and_keeps_the_mode():
    """The layers after the tap do not run; the model's train/eval mode
    is what it was."""
    model = tregistry.MODEL_REGISTRY["Unet"].build(C, dtype=torch.float32)
    model.train()
    ran = []
    model.decode_forward1.register_forward_hook(lambda *a: ran.append(1))
    feats = tfeat.extract_features(model, torch.zeros(1, P, P, 3))
    assert feats.shape == (1, P // 16, P // 16, 1024)
    assert not ran and model.training


@pytest.mark.parametrize("name", ["SwinUnetTiny"])
def test_nets_without_a_tap_raise_as_in_jax(name):
    model = tregistry.MODEL_REGISTRY[name].build(C, dtype=torch.float32)
    with pytest.raises(ValueError, match="no retrieval tap"):
        tfeat.extract_features(model, torch.zeros(1, P, P, 3))
    jmodel, _ = jax_build_model(name, C)
    with pytest.raises(ValueError, match="no retrieval tap"):
        jfeat._tap_filter(jmodel)
