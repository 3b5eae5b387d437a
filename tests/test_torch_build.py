"""The kernel build's library name: a hash of the source, every header under
``csrc/`` and the flags, so an edited header (``swin_tiles.cuh``, shared by
the window-attention forward and backward) can never leave a stale
library in use. The host tier's library (``native/tile_reader.cpp`` and
the ``*.h`` beside it) is named the same way. Runs on the CPU: nothing is
compiled.
"""

import shutil

import pytest

from cvcs_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the package's csrc/ that the test may edit."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_every_swin_source_includes_the_shared_header():
    for name in ("swin_attn", "swin_attn_bwd"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "swin_tiles.cuh"' in text, name


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_an_edit_changes_the_library_name(csrc, edit):
    before = {n: _build.library_path(n) for n in ("swin_attn", "augment")}
    assert before == {n: _build.library_path(n) for n in before}  # stable
    if edit == "header":
        with open(csrc / "swin_tiles.cuh", "a") as f:
            f.write("\n// edited\n")
    elif edit == "source":
        with open(csrc / "swin_attn.cu", "a") as f:
            f.write("\n// edited\n")
    else:
        (csrc / "extra.cuh").write_text("#pragma once\n")
    after = {n: _build.library_path(n) for n in before}
    assert after["swin_attn"] != before["swin_attn"]
    assert after["swin_attn"].parent == before["swin_attn"].parent
    # a header edit rebuilds every source (any may include it); a source
    # edit only its own library
    assert (after["augment"] != before["augment"]) == (edit != "source")


@pytest.fixture
def native_src(tmp_path):
    """A copy of the host tier's sources that the test may edit."""
    from cvcs_tpu_torch import native

    copy = tmp_path / "native"
    copy.mkdir()
    for p in native.SOURCE.parent.iterdir():
        if p.suffix in (".cpp", ".h"):
            shutil.copy(p, copy / p.name)
    return copy / native.SOURCE.name


@pytest.mark.parametrize("edit", ["header", "source", "new_header"])
def test_an_edit_changes_the_host_library_name(native_src, edit):
    before = _build.host_library_path(native_src)
    assert before == _build.host_library_path(native_src)        # stable
    if edit == "header":
        with open(native_src.with_name("zlib_calls.h"), "a") as f:
            f.write("\n// edited\n")
    elif edit == "source":
        with open(native_src, "a") as f:
            f.write("\n// edited\n")
    else:
        native_src.with_name("extra.h").write_text("#pragma once\n")
    after = _build.host_library_path(native_src)
    assert after != before and after.parent == before.parent
