"""The port's retrieval entry point (``cvcs_tpu_torch.cli.retrieve``)
against the JAX package's (``cvcs_tpu.cli.retrieve``) on the synthetic
GID15 set (4 scenes of 96 x 128, p 32: a pool of 48 patches), on the CPU.

* Mask-only mode: the same probes, and every score's top-10 ranking
  equal to JAX's under the tie rule of ``tests/test_torch_retrieval.py``
  (runs of candidates whose JAX scores differ by at most 1e-6; a run cut
  by ``topk`` gives members of that run); no ``agreement`` in either.
* ``net: vits16`` with a DINO-named checkpoint (the JAX tests' DINO twin
  at ViT-S/16's widths, random weights), f32, cosine distance, two
  scenes: the same probes and mask rankings, the agreement benchmark's
  values equal to JAX's within 1e-6, and the CLS embeddings of the pool
  within 1e-5 * max(1, |ref|max) of JAX's (``build_embedder`` against
  ``_build_embedder``).
* ``main`` runs a YAML config; ``device`` other than ``cpu`` needs a card
  (``tests/test_torch_isolation.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cvcs_tpu.cli import retrieve as jretrieve
from cvcs_tpu.data.loader import ChunkLoader as JChunkLoader
from cvcs_tpu.retrieval import scores as jscores
from cvcs_tpu_torch.cli import retrieve as tretrieve
from test_torch_retrieval import assert_same_ranking, tie_runs
from test_torch_segformer import _close
from test_vit import _TorchDinoTwin
from tests.conftest import PATCH

C = 16
RANKED = (("emd", False), ("miou", True), ("wiou", True), ("pprec", True))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pool_masks(root, images=None) -> np.ndarray:
    """The candidate pool's masks as the JAX entry point loads them."""
    loader = JChunkLoader(str(root), chunk_size=1, patch_size=PATCH,
                          load_context=False, seed=0)
    if images:
        loader.specify(images)
    return np.concatenate([
        np.asarray(loader.get_chunk(c, shuffle_patches=False).masks)
        for c in range(len(loader))])


def _assert_mask_rankings(got: dict, want: dict, masks: np.ndarray) -> None:
    assert got["num_probes"] == want["num_probes"]
    assert ([r["probe"] for r in got["mask_rankings"]]
            == [r["probe"] for r in want["mask_rankings"]])
    for g, w in zip(got["mask_rankings"], want["mask_rankings"]):
        p = w["probe"]
        values = {k: np.asarray(v) for k, v in jscores.compute_scores(
            masks[p], masks, C).items()}
        for key, higher in RANKED:
            order = [k for k in jscores.rank_candidates(values[key], higher)
                     if k != p]
            assert_same_ranking(g[key], w[key], tie_runs(order, values[key]))


def test_mask_only_retrieve_matches_jax(gid15_root):
    config = dict(dataset=str(gid15_root), patch_size=PATCH, num_probes=5,
                  topk=10, seed=0)
    want = jretrieve.retrieve(dict(config))
    got = tretrieve.retrieve(dict(config, device="cpu"))
    assert set(got) == set(want) == {"num_probes", "mask_rankings",
                                     "timings"}
    assert all(len(r["emd"]) == 10 for r in got["mask_rankings"])
    _assert_mask_rankings(got, want, _pool_masks(gid15_root))


@pytest.fixture(scope="module")
def dino_ckpt(tmp_path_factory):
    torch.manual_seed(1)
    twin = _TorchDinoTwin(384, 12, 6, 16, 14).eval()   # ViT-S/16's widths
    path = tmp_path_factory.mktemp("dino") / "dino_vits16.pth"
    torch.save(twin.state_dict(), path)
    yield str(path)
    path.unlink()                      # 86 MB of the suite's temp disk


def test_dino_retrieve_matches_jax(gid15_root, dino_ckpt):
    config = dict(dataset=str(gid15_root), patch_size=PATCH, num_probes=3,
                  seed=0, net="vits16", precision="f32",
                  load_checkpoint=dino_ckpt, metric="cosine", images=[0, 1])
    want = jretrieve.retrieve(dict(config))
    got = tretrieve.retrieve(dict(config, device="cpu"))
    assert set(got) == set(want)
    _assert_mask_rankings(got, want, _pool_masks(gid15_root, [0, 1]))
    assert set(got["agreement"]) == set(want["agreement"])
    for k, v in want["agreement"].items():
        assert abs(got["agreement"][k] - v) <= 1e-6, k


def test_dino_embeddings_match_jax(gid15_root, dino_ckpt):
    config = dict(net="vits16", precision="f32", load_checkpoint=dino_ckpt)
    images = np.random.default_rng(2).integers(
        0, 256, (4, PATCH, PATCH, 3)).astype(np.uint8)
    jembed, jdesc = jretrieve._build_embedder(config, PATCH)
    embed, desc = tretrieve.build_embedder(config, torch.device("cpu"))
    assert desc == jdesc == "DINO vits16 CLS"
    want = np.asarray(jembed(jnp.asarray(images)))
    got = embed(torch.from_numpy(images))
    assert got.shape == (4, 384) and got.dtype == torch.float32
    _close(got, want, 1e-5, "CLS embeddings")


def test_main_runs_a_config(gid15_root, tmp_path, capsys):
    path = tmp_path / "retrieve.yaml"
    path.write_text(yaml.safe_dump(dict(
        dataset=str(gid15_root), patch_size=PATCH, num_probes=2, topk=3,
        device="cpu", net="MobileNet", precision="f32", pool="mean",
        images=[0])))
    assert tretrieve.main(["retrieve", str(path)]) == 0
    out = capsys.readouterr().out
    assert "embeddings: MobileNet tap, (12, 960)" in out
    assert "top5to50=" in out
