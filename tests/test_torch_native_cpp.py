"""The port's C++ host tier (``cvcs_tpu_torch/native/tile_reader.cpp``,
built with ``g++`` at first use), byte for byte against two references:
PIL's array (``np.asarray(Image.open(p))``, the tier's stated contract),
and the JAX package's C++ tier (``cvcs_tpu.native.decode``) where its
library loads (it builds only where libtiff's headers are; elsewhere
that comparison is left out). The plain version (``native.plain``) must
give the same arrays.

* Each case of ``tests/test_native.py`` (the JAX tier's tests) as a case
  here, its hand-written tiled and big-endian TIFFs by that file's
  ``_write_tiff``; plus PackBits, LZW and Deflate with the horizontal
  predictor, Deflate and LZW in strips of 8 rows, gray+alpha, and PNGs
  at every compression level (PIL's adaptive row filters).
* Sub-formats the tier does not carry give None through ``decode``,
  ``decode_png``/``decode_tiff`` and a prefetched ``take``, leaving
  nothing cached: palette, 16-bit, tRNS, JPEG-compressed TIFFs, and RGB
  TIFFs whose fourth sample PIL drops or un-premultiplies.
* Files it cannot read raise ``OSError`` naming the path, the same error
  from ``decode`` and from the ``take`` of a prefetched decode: missing,
  not an image, truncated TIFFs (uncompressed and LZW), a PNG with a bad
  CRC, a truncated PNG.
* The prefetcher keeps the JAX semantics: one worker decode per queued
  path (a second ``prefetch`` of a pending or cached path does nothing),
  an inline decode on a cold miss, ``take`` removes the entry, and two
  threads taking one path both return (the loser decodes inline).
* The writer: PNGs of 1, 3 and 4 channels (one over two IDAT chunks) and
  the port's mask exports read back equal under PIL; ``write_png_async``
  copies the caller's buffer; a failed write is counted once, at the
  next flush.
"""

import struct
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cvcs_tpu import native as jax_native
from cvcs_tpu_torch import native
from cvcs_tpu_torch.data import reader
from cvcs_tpu_torch.data.palette import PALETTE
from cvcs_tpu_torch.native import plain
from _bounded import bounded_call
from test_native import _write_tiff


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX tier's library where it builds, else None."""
    return jax_native.load()


def _image(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _smooth(shape):
    """Gradients and edges: PIL's adaptive filter picks every row filter."""
    h, w = shape[:2]
    y, x = np.mgrid[:h, :w]
    a = ((x * 3 + y * 5) % 256 + (x // 7 == y // 5) * 40) % 256
    a = a.astype(np.uint8)
    if len(shape) == 2:
        return a
    return np.stack([a, a[::-1], a[:, ::-1], 255 - a][:shape[2]], -1)


def _counts():
    lib = native.load()
    return lib.tr_decode_count(1), lib.tr_decode_count(0)


def _same(path, jax_lib, want=None) -> np.ndarray:
    """native.decode(path) equals PIL's array, the plain tier's, ``want``
    and the JAX tier's where it loads."""
    got = native.decode(path)
    pil = np.asarray(Image.open(path))
    assert got is not None, path
    assert (got.dtype, got.shape) == (pil.dtype, pil.shape)
    np.testing.assert_array_equal(got, pil)
    np.testing.assert_array_equal(plain.decode(path), got)
    if want is not None:
        np.testing.assert_array_equal(got, want)
    if jax_lib is not None:
        np.testing.assert_array_equal(jax_native.decode(path), got)
    return got


SHAPES = [(37, 53), (41, 29, 3), (23, 31, 4), (19, 27, 2)]
CODECS = [None, "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits"]


@pytest.mark.parametrize("comp", CODECS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pil_tiff_decodes_as_pil(tmp_path, jax_lib, shape, comp):
    arr = _image(shape, seed=len(shape) * 10 + shape[-1])
    path = tmp_path / "t.tif"
    Image.fromarray(arr).save(path, compression=comp)
    _same(path, jax_lib, arr)
    assert native.decode_tiff(path) is not None


@pytest.mark.parametrize("tiffinfo", [{317: 2}, {278: 8}, {317: 2, 278: 8}],
                         ids=["predictor2", "strips8", "predictor2-strips8"])
@pytest.mark.parametrize("comp", ["tiff_lzw", "tiff_deflate", "packbits"])
@pytest.mark.parametrize("shape", [(45, 37, 3), (33, 40, 2)], ids=str)
def test_predicted_and_stripped_tiffs(tmp_path, jax_lib, shape, comp,
                                      tiffinfo):
    arr = _smooth(shape)
    path = tmp_path / "p.tif"
    Image.fromarray(arr).save(path, compression=comp, tiffinfo=tiffinfo)
    _same(path, jax_lib, arr)


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("shape", [(37, 53), (41, 29, 3), (18, 22, 4)],
                         ids=str)
def test_handwritten_tiffs(tmp_path, jax_lib, shape, tiled, big_endian):
    """Tiles cropped at the right and bottom edges and either byte order
    (PIL cannot write them)."""
    arr = _image(shape, seed=7)
    path = _write_tiff(tmp_path / "h.tif", arr, tiled=tiled,
                       big_endian=big_endian)
    _same(path, jax_lib, arr)


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("shape", [(37, 53, 3), (8, 8), (21, 34, 4),
                                   (17, 26, 2), (64, 64, 3)], ids=str)
def test_pngs_decode_as_pil(tmp_path, jax_lib, shape, level):
    arr = _smooth(shape) if shape[0] == 64 else _image(shape, seed=level)
    path = tmp_path / "i.png"
    Image.fromarray(arr).save(path, compress_level=level)
    _same(path, jax_lib, arr)
    np.testing.assert_array_equal(native.decode_png(path), arr)


def _patch_tag(path, tag, value=None, scale=None):
    """Set the inline value of ``tag`` in a little-endian TIFF's first
    IFD: to ``value``, or its own value times ``scale``."""
    data = bytearray(path.read_bytes())
    ifd = struct.unpack_from("<I", data, 4)[0]
    for at in range(ifd + 2, ifd + 2 + 12 * data[ifd], 12):
        t, typ, _ = struct.unpack_from("<HHI", data, at)
        if t == tag:
            fmt = "<H" if typ == 3 else "<I"
            old = struct.unpack_from(fmt, data, at + 8)[0]
            struct.pack_into(fmt, data, at + 8,
                             value if scale is None else int(old * scale))
            path.write_bytes(bytes(data))
            return
    raise KeyError(tag)


def _premultiplied(path, a):
    Image.fromarray(np.dstack([a, a[..., :1]])).save(path)
    _patch_tag(path, 338, 1)              # ExtraSamples: associated alpha


UNSUPPORTED = {
    "palette.png": lambda p, a: Image.fromarray(a).convert("P").save(p),
    "palette.tif": lambda p, a: Image.fromarray(a).convert("P").save(p),
    "gray16.png": lambda p, a: Image.fromarray(
        a[..., 0].astype(np.uint16) * 257).save(p),
    "gray16.tif": lambda p, a: Image.fromarray(
        a[..., 0].astype(np.uint16) * 257).save(p),
    "trns.png": lambda p, a: Image.fromarray(a).save(p, transparency=(0, 0, 0)),
    "jpeg.tif": lambda p, a: Image.fromarray(a).save(p, compression="jpeg"),
    "rgbx.tif": lambda p, a: Image.fromarray(
        np.dstack([a, a[..., :1]])).convert("RGBX").save(p),
    "rgba_premultiplied.tif": _premultiplied,
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unsupported_sub_formats_are_none(tmp_path, name):
    path = tmp_path / name
    UNSUPPORTED[name](path, _image((16, 24, 3), seed=3))
    assert np.asarray(Image.open(path)).size      # PIL decodes it
    per_format = (native.decode_tiff if path.suffix == ".tif"
                  else native.decode_png)
    assert native.decode(path) is None
    assert per_format(path) is None
    native.prefetch(path)
    assert native.take(path) is None
    assert native.load().tr_cache_size() == 0


def _truncated_tiff(path):
    Image.fromarray(_image((40, 50, 3))).save(path)
    path.write_bytes(path.read_bytes()[:3000])


def _truncated_lzw(path):
    Image.fromarray(_image((40, 50, 3))).save(
        path, compression="tiff_lzw", tiffinfo={278: 40})   # one strip
    _patch_tag(path, 279, scale=0.5)      # its codes end half way


def _bad_crc(path):
    Image.fromarray(_image((20, 30, 3))).save(path)
    data = bytearray(path.read_bytes())
    data[data.index(b"IDAT") + 10] ^= 0xFF       # a byte of IDAT's data
    path.write_bytes(bytes(data))


def _truncated_png(path):
    Image.fromarray(_image((20, 30, 3))).save(path)
    path.write_bytes(path.read_bytes()[:-30])


UNREADABLE = {
    "missing.png": None,
    "missing.tif": None,
    "not_an_image.png": lambda p: p.write_bytes(b"not a png"),
    "truncated.tif": _truncated_tiff,
    "truncated_lzw.tif": _truncated_lzw,
    "bad_crc.png": _bad_crc,
    "truncated.png": _truncated_png,
}


@pytest.mark.parametrize("name", sorted(UNREADABLE))
def test_unreadable_files_raise_oserror(tmp_path, name):
    path = tmp_path / name
    if UNREADABLE[name] is not None:
        UNREADABLE[name](path)
    with pytest.raises(OSError) as inline:
        native.decode(path)
    assert str(path) in str(inline.value)
    if name.startswith("missing"):
        assert isinstance(inline.value, FileNotFoundError)
    native.prefetch(path)
    with pytest.raises(OSError) as taken:        # decoded on the worker
        native.take(path)
    assert str(taken.value) == str(inline.value)
    assert native.load().tr_cache_size() == 0


def test_prefetch_then_take_on_the_worker(tmp_path, jax_lib):
    arrs = [_image((16, 16, 3), seed=i) for i in range(3)]
    paths = []
    for i, a in enumerate(arrs):
        paths.append(tmp_path / f"p{i}.png")
        Image.fromarray(a).save(paths[-1])
        paths.append(tmp_path / f"t{i}.tif")
        Image.fromarray(a).save(paths[-1], compression="tiff_lzw")
    worker, inline = _counts()
    for p in paths:
        native.prefetch(p)
        native.prefetch(p)                   # pending or cached: nothing
    for p, a in zip(paths, [a for a in arrs for _ in range(2)]):
        got = native.take(p)
        np.testing.assert_array_equal(got, a)
        assert got.flags.writeable
    assert _counts() == (worker + len(paths), inline)
    assert native.load().tr_cache_size() == 0


def test_take_cold_miss_decodes_inline(tmp_path):
    arr = np.zeros((4, 4, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "cold.png")
    worker, inline = _counts()
    np.testing.assert_array_equal(native.take(tmp_path / "cold.png"), arr)
    assert _counts() == (worker, inline + 1)


def test_two_threads_take_one_path(tmp_path):
    """Both return (the old cache-only wait predicate hung the loser once
    the winner removed the entry); the loser decodes inline."""
    arr = _image((64, 64, 3), seed=1)
    path = tmp_path / "race.png"
    Image.fromarray(arr).save(path)
    worker, inline = _counts()
    native.prefetch(path)
    results = [None, None]

    def take(i):
        results[i] = native.take(path)

    threads = [threading.Thread(target=take, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads), "take() deadlocked"
    for r in results:
        np.testing.assert_array_equal(r, arr)
    assert _counts() == (worker + 1, inline + 1)
    assert native.load().tr_cache_size() == 0


def test_scene_dataset_reads_tiff_scenes(tmp_path, jax_lib):
    """A GID15-style root whose scenes and index masks are TIFFs (the real
    layout), its colour mask a TIFF too, through the port's reader."""
    root = tmp_path / "gid_tif"
    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    (root / "Annotation__color").mkdir()
    img = _image((32, 48, 4), seed=23)       # NirRGB: 4 bands
    mask = _image((32, 48), seed=24) % 16
    Image.fromarray(img).save(root / "Image__8bit_NirRGB" / "s.tif",
                              compression="tiff_lzw")
    Image.fromarray(mask).save(root / "Annotation__index" / "s_15label.tif")
    Image.fromarray(PALETTE[mask]).save(
        root / "Annotation__color" / "s_15label.tif")
    ds = reader.SceneDataset(root)
    ds.prefetch(range(len(ds)))
    np.testing.assert_array_equal(ds.load_image(0), img)
    np.testing.assert_array_equal(ds.load_index_mask(0), mask)
    _same(root / "Annotation__color" / "s_15label.tif", jax_lib,
          PALETTE[mask])


def test_scene_dataset_reads_the_gid15_root(gid15_root):
    ds = reader.SceneDataset(gid15_root)
    ds.prefetch(range(len(ds)))
    for i in range(len(ds)):
        np.testing.assert_array_equal(
            ds.load_image(i), np.asarray(Image.open(ds.image_paths[i])))
        np.testing.assert_array_equal(
            ds.load_index_mask(i),
            np.asarray(Image.open(ds.index_mask_path(i))))
    assert native.load().tr_cache_size() == 0


@pytest.mark.parametrize("shape", [(9, 13, 3), (6, 6), (5, 7, 4),
                                   (700, 700, 3)], ids=str)
def test_write_png_reads_back(tmp_path, shape):
    """The last shape's 1.47 MB of noise spans two IDAT chunks."""
    arr = _image(shape, seed=2)
    path = tmp_path / "w.png"
    assert native.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(native.decode_png(path), arr)


def test_write_png_refuses_two_channels(tmp_path):
    arr = _image((4, 5, 2))
    assert not native.write_png(tmp_path / "la.png", arr)
    assert native.write_png_async(tmp_path / "la.png", arr)
    assert bounded_call(native.flush_writes, 30) == 1
    assert not (tmp_path / "la.png").exists()


def test_async_writes_copy_and_flush(tmp_path):
    arrs = [_image((8, 8, 3), seed=i) for i in range(5)]
    for i, a in enumerate(arrs):
        buf = a.copy()
        assert native.write_png_async(tmp_path / f"a{i}.png", buf)
        buf[:] = 0                        # the queued write holds a copy
    assert bounded_call(native.flush_writes, 30) == 0
    for i, a in enumerate(arrs):
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"a{i}.png")), a)


def test_async_write_failure_counted_once(tmp_path):
    native.write_png_async(tmp_path / "no_dir" / "x.png",
                           np.zeros((4, 4, 3), np.uint8))
    assert bounded_call(native.flush_writes, 30) == 1
    assert bounded_call(native.flush_writes, 30) == 0


def test_mask_pngs_read_back(tmp_path):
    """The port's mask exports through the C++ writer: a palette mask, and
    ``export_patches``'s per-tile PNGs (``test_native.py``'s export
    case)."""
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

    labels = np.kron(np.arange(16).reshape(4, 4), np.ones((8, 8), np.int64))
    assert native.write_png(tmp_path / "mask.png", PALETTE[labels])
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "mask.png")), PALETTE[labels])
    seg = SceneSegmenter(lambda w: w, InferenceConfig(
        patch_size=16, border_correction=None), device="cpu")
    paths = seg.export_patches(labels, tmp_path / "out")
    assert [Path(p).name for p in paths] == [f"{i}.png" for i in range(4)]
    for i, p in enumerate(paths):
        r, c = divmod(i, 2)
        np.testing.assert_array_equal(
            np.asarray(Image.open(p)),
            PALETTE[labels[r * 16:(r + 1) * 16, c * 16:(c + 1) * 16]])


def test_corrupted_files_give_an_array_none_or_oserror(tmp_path):
    """Bytes overwritten and files cut short at seeded places, in TIFFs of
    each codec and in a PNG: every decode returns or raises OSError, and
    the process lives on."""
    arr = _image((30, 40, 3), seed=9)
    arr[:15] = 7
    seeds = []
    for comp in (None, "tiff_lzw", "tiff_deflate", "packbits"):
        Image.fromarray(arr).save(tmp_path / "s.tif", compression=comp,
                                  tiffinfo={278: 8})
        seeds.append((tmp_path / "s.tif").read_bytes())
    Image.fromarray(arr).save(tmp_path / "s.png")
    seeds.append((tmp_path / "s.png").read_bytes())
    rng = np.random.default_rng(11)
    outcomes = set()
    for i in range(400):
        data = bytearray(seeds[i % len(seeds)])
        for _ in range(rng.integers(1, 4)):
            if rng.random() < 0.25 and len(data) > 2:
                data = data[:rng.integers(1, len(data))]
            else:
                at = rng.integers(len(data))
                data[at:at + 2] = rng.integers(0, 256, 2, np.uint8).tobytes()
        path = tmp_path / f"f{i % len(seeds)}.bin"
        path.write_bytes(bytes(data))
        try:
            got = native.decode(path)
            outcomes.add("none" if got is None else "array")
        except OSError:
            outcomes.add("oserror")
    assert outcomes == {"array", "none", "oserror"}
