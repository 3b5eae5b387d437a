"""The port stands alone, and never runs on the CPU unasked.

* A fresh interpreter imports every ``cvcs_tpu_torch`` module; neither
  ``jax``, ``flax``, ``orbax`` and ``tensorstore`` nor the JAX package
  (``cvcs_tpu`` or ``cvcs_tpu.*`` — the port's own name starts with the
  same letters) may be loaded after: the Orbax reader imports
  ``tensorstore`` only when it reads.
* A source scan finds no jax / flax / orbax import and no ``cvcs_tpu.``
  import.
* The host tier is the port's own: its C++ sources include no ``png.h``,
  ``tiffio.h`` or ``zlib.h``, no module names the JAX package's
  ``native`` tier outside a docstring, and ``native.load()`` loads the
  library built from ``cvcs_tpu_torch/native/tile_reader.cpp``.
* Without ``device="cpu"``, the entry points raise on a machine with no
  card instead of running on the CPU.
"""

import ast
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cvcs_tpu_torch
from _bounded import run_bounded

PKG = Path(cvcs_tpu_torch.__file__).parent
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(
        ".__init__")
    for p in PKG.rglob("*.py"))


def test_modules_found():
    assert "cvcs_tpu_torch.ops.swin_attn" in MODULES
    assert "cvcs_tpu_torch.cli.serve" in MODULES
    # the mesh: covered by the import and source checks below
    assert "cvcs_tpu_torch.core.mesh" in MODULES
    assert "cvcs_tpu_torch.parallel.halo" in MODULES
    assert "cvcs_tpu_torch.parallel.tp" in MODULES
    # the host decode / encode tier (the JAX package's binds C++)
    assert "cvcs_tpu_torch.native" in MODULES


def test_import_pulls_in_no_jax_and_no_jax_package():
    code = "\n".join(
        [f"import {m}" for m in MODULES]
        + ["import sys",
           "bad = sorted(m for m in sys.modules if m in ('jax', 'flax',"
           " 'orbax', 'tensorstore', 'cvcs_tpu') or m.startswith(('jax.',"
           " 'flax.', 'orbax.', 'tensorstore.', 'cvcs_tpu.')))",
           "print(repr(bad))"])
    out = run_bounded([sys.executable, "-c", code], 120, cwd=PKG.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_source_imports_nothing_of_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "orbax",
                                "cvcs_tpu"), (
                f"{path}: imports {name}")


@pytest.mark.parametrize(
    "path", sorted(p for p in PKG.rglob("*") if p.suffix in (".cpp", ".h")),
    ids=lambda p: str(p.relative_to(PKG)))
def test_host_sources_include_no_format_headers(path):
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]',
                          path.read_text(), re.M)
    assert not {"png.h", "tiffio.h", "zlib.h"} & {
        Path(i).name for i in includes}, (path, includes)


def test_the_host_tier_is_the_ports_own():
    from cvcs_tpu_torch import native
    from cvcs_tpu_torch.ops import _build

    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                  ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)}
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not re.search(r"cvcs_tpu[./]native|libtile_reader\.so",
                                     node.value), (path, node.value)
    assert native.SOURCE == PKG / "native" / "tile_reader.cpp"
    lib = Path(native.load()._name)
    assert lib == _build.host_library_path(native.SOURCE)
    assert lib.parent == PKG.parent / "build" / "native"


@pytest.fixture
def no_card(monkeypatch):
    """Stand in for a machine without a card, wherever the tests run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_the_cpu_unasked(no_card, tmp_path):
    from cvcs_tpu_torch.cli import predict, serve
    from cvcs_tpu_torch.core.device import resolve_device
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter
    from cvcs_tpu_torch.models import build_model

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("SwinUnetTiny", 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SceneSegmenter(lambda w: w, InferenceConfig(patch_size=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(dict(watch_dir=str(tmp_path), net="SwinUnetTiny",
                         max_polls=1))
    (tmp_path / "Image__8bit_NirRGB").mkdir()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict.predict(dict(dataset=str(tmp_path), net="SwinUnetTiny",
                             patch_size=32, device="cuda"))
    # asked for, the CPU works
    model, _ = build_model("SwinUnetTiny", 16, device="cpu",
                           dtype=torch.float32)
    seg = SceneSegmenter(model, InferenceConfig(patch_size=32,
                                                border_correction=None),
                         device="cpu")
    assert seg.predict_scene(np.zeros((32, 64, 3), np.uint8)).shape == (32, 64)


def test_retrieve_and_export_refuse_the_cpu_unasked(no_card, tmp_path):
    from cvcs_tpu_torch.cli import export, retrieve

    assert {"cvcs_tpu_torch.cli.retrieve", "cvcs_tpu_torch.cli.export",
            "cvcs_tpu_torch.models.vit", "cvcs_tpu_torch.retrieval.scores",
            "cvcs_tpu_torch.retrieval.features", "cvcs_tpu_torch.utils.debug",
            "cvcs_tpu_torch.utils.profiling"} <= set(MODULES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrieve.retrieve(dict(dataset=str(tmp_path), patch_size=32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export(dict(net="SwinUnetTiny", load_checkpoint="x",
                           output=str(tmp_path / "o.pt")))


def test_kernel_wrapper_has_no_fallback_off_cpu():
    """A tensor on another device is refused, never run by the plain
    version: only a CPU tensor takes it."""
    from cvcs_tpu_torch.ops import swin_attn

    x = torch.zeros(1, 4, 4, 8, device="meta")
    w = [torch.zeros(s, device="meta") for s in
         ((8,), (8,), (8, 24), (24,), (8, 8), (8,))]
    with pytest.raises(ValueError, match="no swin_attn kernel"):
        swin_attn.swin_window_attention(x, *w, None, win=4, heads=1)
