"""The port's host decode and encode tier (``cvcs_tpu_torch.native``), on
synthetic PNG and TIFF rasters written with PIL.

* ``prefetch`` + ``take`` return what the JAX package's
  ``SceneDataset.load_image`` / ``load_index_mask`` return for the same
  files, decoded on the C++ worker (its decode counters), and ``take``
  removes the entry; a path never queued decodes inline on the calling
  thread; a decode that failed on the worker raises at ``take`` what an
  inline decode raises (a second ``take`` decodes inline and raises
  again); a sub-format the tier does not carry (palette) gives None.
* ``write_png_async`` copies its array (the caller's buffer is changed
  after the call) and ``flush_writes`` returns once the files decode to
  the arrays; an unwritable path counts one failure, and the count is
  reset by the flush. The plain version's writer
  (``native.plain``): an encode that raises anything is counted too, and
  the writer thread goes on writing.
* ``ChunkLoader.get_chunk(c)`` queues chunk c + 1's images and masks
  (a spy) and gives the chunks of a loader whose prefetch does nothing.
* The serve daemon through the tier, on a PNG and a TIFF raster of one
  shape: the batch is queued before its first ``take``, the masks are
  queued and flushed before the journal names them (a spy on
  ``flush_writes``: no journaled entry before it, every mask file after
  it), and the masks are the palette of the JAX engine's labels on at
  least 99.9% of the pixels, as ``tests/test_torch_serve.py`` holds
  them.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from cvcs_tpu.data.palette import PALETTE
from cvcs_tpu.data.reader import SceneDataset as JaxSceneDataset
from cvcs_tpu.infer import InferenceConfig as JaxInferenceConfig
from cvcs_tpu.infer import SceneSegmenter as JaxSceneSegmenter
from cvcs_tpu.models.swin import SwinUNet as JaxSwinUNet
from cvcs_tpu_torch import native
from cvcs_tpu_torch.cli import serve as serve_cli
from cvcs_tpu_torch.native import plain
from cvcs_tpu_torch.data import loader as loader_lib
from cvcs_tpu_torch.data import reader
from cvcs_tpu_torch.weights import flatten_variables
from _bounded import bounded_call
from test_torch_engine import scene
from test_torch_serve import BC, P, TINY_NET
from test_torch_spatial import _numpy_variables


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """SwinUnetTiny JAX variables (16 classes) drawn with numpy on the
    shapes of ``init`` (nothing compiled), saved as an .npz."""
    model = JaxSwinUNet(num_classes=16, dtype=jax.numpy.float32, **TINY_NET)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(7)},
        jax.numpy.zeros((1, P, P, 3), jax.numpy.float32), train=False))
    variables = _numpy_variables(shapes, 7)
    path = tmp_path_factory.mktemp("ckpt") / "swin_tiny.npz"
    np.savez(path, **flatten_variables(variables))
    return model, variables, path


def _dataset(root):
    """A GID15-style root: a PNG and a TIFF scene, their index masks as a
    PNG and a TIFF."""
    rng = np.random.default_rng(3)
    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    for i, ext in enumerate((".png", ".tif")):
        img = rng.integers(0, 256, (48, 64, 3), np.uint8)
        msk = rng.integers(0, 16, (48, 64), np.uint8)
        Image.fromarray(img).save(root / "Image__8bit_NirRGB" / f"s{i}{ext}")
        Image.fromarray(msk).save(
            root / "Annotation__index" / f"s{i}_15label{ext}")
    return root


def _decodes():
    """(decodes on the C++ worker, decodes inline in take) so far."""
    lib = native.load()
    return lib.tr_decode_count(1), lib.tr_decode_count(0)


def test_prefetch_and_take_equal_jax_scene_dataset(tmp_path):
    root = _dataset(tmp_path / "d")
    want = JaxSceneDataset(root)
    mine = reader.SceneDataset(root)
    worker, inline = _decodes()
    mine.prefetch([0, 1])
    for i in range(2):
        np.testing.assert_array_equal(mine.load_image(i), want.load_image(i))
        np.testing.assert_array_equal(mine.load_index_mask(i),
                                      want.load_index_mask(i))
    # every raster decoded once, on the worker; the cache is empty again
    assert _decodes() == (worker + 4, inline)
    assert native.load().tr_cache_size() == 0


def test_a_miss_decodes_inline_and_a_palette_is_not_carried(tmp_path):
    arr = np.random.default_rng(4).integers(0, 256, (20, 30, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "a.tif")
    worker, inline = _decodes()
    np.testing.assert_array_equal(native.take(tmp_path / "a.tif"), arr)
    assert _decodes() == (worker, inline + 1)
    Image.fromarray(arr[..., 0]).convert("P").save(tmp_path / "p.png")
    native.prefetch(tmp_path / "p.png")
    assert native.take(tmp_path / "p.png") is None
    assert native.load().tr_cache_size() == 0


def test_a_failed_prefetch_raises_at_take(tmp_path):
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with pytest.raises(Exception) as inline:
        native.decode(bad)
    native.prefetch(bad)
    with pytest.raises(type(inline.value), match=str(inline.value)):
        native.take(bad)
    assert native.load().tr_cache_size() == 0
    with pytest.raises(type(inline.value)):      # not cached as a success
        native.take(bad)


def test_async_writes_copy_land_and_count_failures(tmp_path):
    rng = np.random.default_rng(5)
    arrays = {"rgb.png": rng.integers(0, 256, (17, 23, 3), np.uint8),
              "gray.png": rng.integers(0, 256, (9, 11), np.uint8),
              "rgba.png": rng.integers(0, 256, (5, 7, 4), np.uint8)}
    for name, arr in arrays.items():
        buf = arr.copy()
        assert native.write_png_async(tmp_path / name, buf)
        buf[:] = 0                      # the queued write holds a copy
    assert native.write_png_async(tmp_path / "missing" / "x.png",
                                  arrays["rgb.png"])
    assert bounded_call(native.flush_writes, 30) == 1
    for name, arr in arrays.items():
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / name)),
                                      arr)
    assert bounded_call(native.flush_writes, 30) == 0
    assert native.write_png(tmp_path / "sync.png", arrays["rgb.png"])
    assert not native.write_png(tmp_path / "missing" / "y.png",
                                arrays["rgb.png"])


def test_an_encode_that_raises_is_counted_and_the_writer_lives_on(
        tmp_path, monkeypatch):
    encode = plain._encode
    arr = np.arange(12, dtype=np.uint8).reshape(3, 4)

    def broken(path, a):
        raise TypeError("broken encoder")

    def flush():
        # bounded: a writer that died would leave flush_writes waiting
        return bounded_call(plain.flush_writes, 10)

    monkeypatch.setattr(plain, "_encode", broken)
    assert plain.write_png_async(tmp_path / "a.png", arr)
    assert flush() == 1
    monkeypatch.setattr(plain, "_encode", encode)
    assert plain.write_png_async(tmp_path / "b.png", arr)
    assert flush() == 0
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "b.png")),
                                  arr)


def test_get_chunk_queues_the_next_chunk(gid15_root, monkeypatch):
    kw = dict(chunk_size=2, patch_size=32, random_shift=True, seed=3,
              device="cpu")
    queued = []
    prefetch = native.prefetch
    monkeypatch.setattr(native, "prefetch",
                        lambda p: queued.append(p.name) or prefetch(p))
    mine = loader_lib.ChunkLoader(str(gid15_root), **kw)
    got = [mine.get_chunk(c) for c in range(len(mine))]
    monkeypatch.setattr(reader.SceneDataset, "prefetch", lambda *a: None)
    serial = loader_lib.ChunkLoader(str(gid15_root), **kw)
    want = [serial.get_chunk(c) for c in range(len(serial))]
    ds = mine.dataset
    assert queued == [p.name for i in mine.chunks[1]
                      for p in (ds.image_paths[i], ds.index_mask_path(i))]
    assert native.load().tr_cache_size() == 0
    for a, b in zip(got, want):
        assert torch.equal(a.images, b.images)
        assert torch.equal(a.masks, b.masks)


def test_serve_through_the_tier(tmp_path, carried, monkeypatch):
    model, variables, ckpt = carried
    watch = tmp_path / "in"
    watch.mkdir()
    rasters = {"a.png": scene(seed=21, h=64, w=96),
               "b.tif": scene(seed=22, h=64, w=96)}
    for name, arr in rasters.items():
        Image.fromarray(arr).save(watch / name)
    out = watch / "output"
    calls, flushed = [], []
    prefetch, take, flush = native.prefetch, native.take, native.flush_writes

    def spy_flush():
        journaled = ((out / "manifest.jsonl").read_text()
                     if (out / "manifest.jsonl").exists() else "")
        failures = flush()
        flushed.append((journaled, sorted(p.name for p in out.glob("*.png"))))
        return failures

    monkeypatch.setattr(native, "prefetch",
                        lambda p: calls.append(("prefetch", p.name))
                        or prefetch(p))
    monkeypatch.setattr(native, "take", lambda p: calls.append(
        ("take", p.name)) or take(p))
    monkeypatch.setattr(native, "flush_writes", spy_flush)
    config = dict(watch_dir=str(watch), net="SwinUnetTiny",
                  load_checkpoint=str(ckpt), patch_size=P,
                  border_correction=BC, batch_tiles=5, num_classes=15,
                  precision="f32", device="cpu", max_polls=1, poll_s=0)
    assert serve_cli.serve(config) == 2
    assert calls == [("prefetch", "a.png"), ("prefetch", "b.tif"),
                     ("take", "a.png"), ("take", "b.tif")]
    entries = [json.loads(line) for line in
               (out / "manifest.jsonl").read_text().splitlines()]
    masks = sorted(e["mask"] for e in entries)
    assert masks == ["a_mask.png", "b_mask.png"]
    assert flushed == [("", masks)]       # one flush, before the journal
    jseg = JaxSceneSegmenter(model.apply, variables, JaxInferenceConfig(
        patch_size=P, border_correction=BC, batch_tiles=5, num_classes=16))
    for name, arr in rasters.items():
        mask = np.asarray(Image.open(out / f"{name[0]}_mask.png"))
        want = PALETTE[np.asarray(jseg.predict_scene(arr))]
        assert mask.shape == want.shape
        assert (mask == want).all(-1).mean() >= 0.999, name
