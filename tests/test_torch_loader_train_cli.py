"""Port's data loader, metrics, checkpoints and train CLI, on the CPU.

* ``ChunkLoader``: for one seed and no augmentation, every chunk of two
  epochs (scene shuffle, +-20 px shifts, patch permutation) is bit-equal
  to the JAX loader's; validation chunks too; class weights equal.
* ``DeviceChunk`` tail batches (dropped, padded with ``valid`` flags, or
  at natural size) equal the JAX chunk's.
* The confusion matrix (out-of-range and ignored pixels dropped) and the
  scores equal ``cvcs_tpu.metrics``'.
* ``cli.train`` with ``device: cpu`` on a 448 x 672 synthetic set:
  2 epochs of SwinUnetTiny with the recipe's keys and
  ``augmentation: fused`` write checkpoints; resuming from the epoch-2
  checkpoint continues the histories; a non-finite loss halts training;
  ``load_context`` and ``random_tps`` build (their data is held against
  JAX in ``tests/test_torch_context.py``), ``mesh: {data: 2}`` in one
  process raises ``MeshConfig.resolve``'s ``ValueError`` (the data mesh
  trains in ``tests/test_torch_dp.py``) and ``mesh.spatial > 1``
  ``NotImplementedError`` naming ROADMAP item 14d, as does a checkpoint
  directory holding neither ``state.pt``
  nor an Orbax ``state/``; without a card and without ``device: cpu``
  it raises.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.data.loader import ChunkLoader as JaxChunkLoader
from cvcs_tpu.data.loader import DeviceChunk as JaxDeviceChunk
from cvcs_tpu.metrics import confusion as jconf
from cvcs_tpu.metrics import scores as jscores
from cvcs_tpu.train.loop import _downscale_batch as jax_downscale_batch
from cvcs_tpu_torch.cli import train as train_cli
from cvcs_tpu_torch.data.loader import ChunkLoader, DeviceChunk
from cvcs_tpu_torch.metrics import confusion, scores
from cvcs_tpu_torch.train import checkpoint as ckpt_lib
from cvcs_tpu_torch.train.loop import downscale_batch


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it
    (observed: the train CLI test took 375 s under six workers, 10 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_scenes(root: Path, n: int, seed: int) -> str:
    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (448, 672, 3), dtype=np.uint8)
        m = np.kron(rng.integers(0, 16, (28, 42), dtype=np.uint8),
                    np.ones((16, 16), np.uint8))
        Image.fromarray(img).save(root / "Image__8bit_NirRGB" / f"s{i}.png")
        Image.fromarray(m).save(root / "Annotation__index" / f"s{i}_15label.png")
    return str(root)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = tmp_path_factory.mktemp("vgid")
    return (_write_scenes(base / "train", 4, seed=7),
            _write_scenes(base / "val", 1, seed=8))


def test_chunks_match_jax_loader(dataset):
    train, val = dataset
    kw = dict(chunk_size=2, patch_size=224, random_shift=True, seed=3)
    jl = JaxChunkLoader(train, load_context=False, **kw)
    tl = ChunkLoader(train, device="cpu", **kw)
    assert tl.tpi == jl.tpi == 6
    for _ in range(2):                      # two epochs of reshuffles
        jl.shuffle()
        tl.shuffle()
        assert tl.chunks == jl.chunks
        for c in range(len(jl)):
            want, got = jl.get_chunk(c), tl.get_chunk(c)
            np.testing.assert_array_equal(got.images.numpy(),
                                          np.asarray(want.images))
            np.testing.assert_array_equal(got.masks.numpy(),
                                          np.asarray(want.masks))
            assert got.images.dtype == torch.uint8
            assert got.masks.dtype == torch.int32
    jv = JaxChunkLoader(val, 1, patch_size=224, load_context=False, seed=4)
    tv = ChunkLoader(val, 1, patch_size=224, seed=4, device="cpu")
    want, got = jv.get_chunk(0, shuffle_patches=False), tv.get_chunk(
        0, shuffle_patches=False)
    np.testing.assert_array_equal(got.images.numpy(), np.asarray(want.images))
    for ignore in (False, True):
        np.testing.assert_array_equal(tl.class_weights(16, ignore),
                                      jl.class_weights(16, ignore))
    np.testing.assert_array_equal(tl.class_priors(16), jl.class_priors(16))


@pytest.mark.parametrize("drop_last,pad_tail", [(True, True), (False, True),
                                                (False, False)])
def test_tail_batches_match_jax(drop_last, pad_tail):
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (7, 4, 4, 3), dtype=np.uint8)
    msks = rng.integers(0, 16, (7, 4, 4)).astype(np.int32)
    want = list(JaxDeviceChunk(jnp.asarray(imgs), jnp.asarray(msks), None)
                .batches(3, drop_last, pad_tail))
    got = list(DeviceChunk(torch.from_numpy(imgs), torch.from_numpy(msks))
               .batches(3, drop_last, pad_tail))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.image.numpy(), np.asarray(w.image))
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        assert (g.valid is None) == (w.valid is None)
        if w.valid is not None:
            np.testing.assert_array_equal(g.valid.numpy(),
                                          np.asarray(w.valid))


@pytest.mark.parametrize("ignore_index", [None, 0])
def test_confusion_and_scores_match_jax(ignore_index):
    rng = np.random.default_rng(11)
    c = 6
    pred = rng.integers(0, c, (3, 8, 8)).astype(np.int32)
    target = rng.integers(-1, c + 1, (3, 8, 8)).astype(np.int32)
    target[0, 0] = 3          # a class pred never hits: excluded paths
    want = jconf.update_confusion(jconf.confusion_matrix(c),
                                  jnp.asarray(pred), jnp.asarray(target),
                                  num_classes=c, ignore_index=ignore_index)
    conf = confusion.confusion_matrix(c)
    confusion.update_confusion(conf, torch.from_numpy(pred),
                               torch.from_numpy(target), c, ignore_index)
    host = confusion.HostConfusion(c)
    host.fold(conf)
    np.testing.assert_array_equal(host.total, np.asarray(want))
    np.testing.assert_array_equal(confusion.normalize_rows(host.total),
                                  jconf.normalize_rows(host.total))
    got_m = scores.compute_metrics(host.total)
    want_m = jscores.compute_metrics(host.total)
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        np.testing.assert_array_equal(np.asarray(got_m[k]),
                                      np.asarray(want_m[k]), err_msg=k)


def test_eval_downscale_matches_jax():
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    msk = rng.integers(0, 16, (2, 8, 8)).astype(np.int32)
    want_img, want_msk = jax_downscale_batch(jnp.asarray(img),
                                             jnp.asarray(msk), 2)
    got_img, got_msk = downscale_batch(torch.from_numpy(img),
                                       torch.from_numpy(msk), 2)
    assert got_img.dtype == torch.uint8
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_msk.numpy(), np.asarray(want_msk))


def _config(dataset, tmp_path, **extra):
    train, val = dataset
    cfg = dict(
        train=train, validation=val, checkpoint_directory=str(tmp_path / "ck"),
        device="cpu", net="SwinUnetTiny", epochs=2, chunk_size=2,
        validation_chunk_size=1, patch_size=224, batch_size=10, loss="wCEL",
        opt="SGD2", ignore_background=True, random_shift=True,
        augmentation="fused", precision_evaluation_freq=1, precision="bf16",
        metrics_log=str(tmp_path / "metrics.jsonl"), seed=1)
    cfg.update(extra)
    return cfg


def test_train_cli_trains_checkpoints_and_resumes(dataset, tmp_path):
    trainer = train_cli.build_trainer(_config(dataset, tmp_path))
    trainer.train()
    # 4 scenes x 6 tiles in 2 chunks of 12 patches: batches of 10 and 2
    assert len(trainer.training_loss_values) == 2 * 2 * 2
    assert np.isfinite(trainer.training_loss_values).all()
    assert len(trainer.validation_loss_values) == 2
    assert len(trainer.conf_history) == 2
    ck = Path(tmp_path / "ck")
    assert ckpt_lib.latest_checkpoint(ck) == ck / "checkpoint2"
    meta = json.loads((ck / "checkpoint2" / "meta.json").read_text())
    assert meta["epoch"] == 1 and meta["batch_size"] == 10
    assert meta["training_loss_values"] == trainer.training_loss_values
    assert len(meta["conf_flat"]) == 2
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["epoch"] for x in lines] == [1, 2]

    resumed = train_cli.build_trainer(_config(
        dataset, tmp_path, epochs=3, batch_size=4, load_checkpoint="auto"))
    assert resumed.last_epoch == 2
    assert resumed.config.batch_size == 10     # the checkpoint's wins
    assert resumed.state.step == trainer.state.step
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(resumed.state.model.state_dict()[k], v), k
    resumed.train()
    hist = resumed.training_loss_values
    assert hist[:8] == trainer.training_loss_values and len(hist) == 12
    assert len(resumed.validation_loss_values) == 3
    assert ckpt_lib.latest_checkpoint(ck) == ck / "checkpoint3"


def test_train_cli_halts_on_nan_and_refuses_what_it_cannot_run(
        dataset, tmp_path, monkeypatch):
    trainer = train_cli.build_trainer(_config(dataset, tmp_path, epochs=1))
    trainer.loss_fn = lambda logits, labels: logits.float().mean() * np.nan
    with pytest.raises(FloatingPointError, match="non-finite"):
        trainer.train()
    built = train_cli.build_trainer(_config(
        dataset, tmp_path, load_context=True, random_tps=[[300, 0.5]],
        async_checkpoints=True))
    assert built.train_loader.load_context and built.val_loader.load_context
    assert built.config.random_tps == [[300, 0.5]]
    assert built.config.async_checkpoints
    with pytest.raises(ValueError, match="mesh 2x1 does not cover 1 "
                                         "devices"):
        train_cli.build_trainer(_config(dataset, tmp_path,
                                        mesh={"data": 2}))
    with pytest.raises(NotImplementedError, match="item 14d"):
        train_cli.build_trainer(_config(dataset, tmp_path,
                                        mesh={"data": 1, "spatial": 2}))
    with pytest.raises(ValueError, match="remat: true is not supported"):
        train_cli.build_trainer(_config(dataset, tmp_path, remat=True))
    torn = tmp_path / "ck" / "checkpoint9" / "state"
    torn.mkdir(parents=True)                    # no _METADATA: not Orbax's
    with pytest.raises(FileNotFoundError, match="Orbax"):
        ckpt_lib.load_checkpoint(torn.parent, trainer.state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(dataset, tmp_path)
    del cfg["device"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.build_trainer(cfg)
