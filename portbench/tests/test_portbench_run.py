"""Runs of the harness on the CPU at a small size: a measured run with no
card fails; the isolation guards; a cell, configuration, traffic mix and
per-layer metric added by new files and entries alone; and the timed
path broken underneath, which the correctness check must catch."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 3_000_000_123          # above 2**31: seeds need more than 32 bits
TINY_SCENE = dict(scene=[96, 136, 3], patch_size=32, border_correction=64,
                  batch_tiles=4, check_tiles=48, check_block=8,
                  traced_scenes=2)
TINY_TRAIN = dict(scene=[96, 128, 3], patch_size=32, batch_size=4,
                  mask_block=8)


def traffic_of(cell, root=ROOT, **tiny):
    man = json.loads((root / "BENCHMARK.json").read_text())
    w = {x["name"]: x for x in man["workloads"]}[cell]
    t = json.loads((root / "portbench/traffic" / f"{w['traffic']}.json")
                   .read_text())
    t.update(TINY_SCENE if t["driver"] == "scene" else TINY_TRAIN)
    t.update(tiny)
    return t


def run_cpu(cell, seconds=1.0, trace=False, root=ROOT):
    b = harness.bench_for(root, cell, SEED, seconds, trace, "cpu",
                          traffic=traffic_of(cell, root))
    result, checks = harness.run(b, time.perf_counter())
    json.dumps(result, allow_nan=False)       # a valid result line
    return result, {k: (v, lim) for k, v, lim in checks}


def test_measured_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure it")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "unetv2.scene",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_guard_compares_whole_top_level_names(monkeypatch):
    assert "cvcs_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "cvcs_tpu_torch_x",
                        types.ModuleType("cvcs_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.np"))
    monkeypatch.setitem(sys.modules, "cvcs_tpu.ops",
                        types.ModuleType("cvcs_tpu.ops"))
    assert harness.forbidden_modules() == ["cvcs_tpu", "jax"]


def _copy(tmp_path) -> Path:
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return root


def test_reference_may_not_import_the_program(tmp_path):
    root = _copy(tmp_path)
    assert harness.reference_imports(root) == []
    (root / "portbench/reference/extra.py").write_text(
        "import torch\nfrom cvcs_tpu_torch.models import blocks\n")
    assert harness.reference_imports(root) == [
        "extra.py: cvcs_tpu_torch.models"]
    b = harness.bench_for(root, "unetv2.scene", SEED, 1.0, False, "cpu",
                          traffic=traffic_of("unetv2.scene", root))
    with pytest.raises(SystemExit, match="imports the program"):
        harness.run(b, time.perf_counter())


def test_a_new_cell_takes_only_new_files_and_entries(tmp_path):
    root = _copy(tmp_path)
    pb = root / "portbench"
    cfg = json.loads((pb / "configs/swinunet.json").read_text())
    cfg.update(name="swintiny", net="SwinUnetTiny", dims=[32, 64, 128, 256],
               depths=[1, 1, 2, 1], heads=[1, 2, 4, 8])
    (pb / "configs/swintiny.json").write_text(json.dumps(cfg))
    (pb / "reference/swintiny.py").write_text(
        "from portbench.reference.swinunet import forward, param_specs\n")
    traffic = json.loads((pb / "traffic/scene.json").read_text())
    traffic.update(TINY_SCENE, path={"stream_rows": 1})
    (pb / "traffic/scene_bands.json").write_text(json.dumps(traffic))
    (pb / "metrics/tiles.scene.py").write_text(
        "def read(r):\n    return float(r['units'])\n")
    (pb / "limits/swintiny.scene_bands.json").write_text(
        json.dumps({"label_gap": 1e9}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "swintiny", "source": "a test",
                           "file": "portbench/configs/swintiny.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "swintiny.scene_bands",
                             "config": "swintiny", "traffic": "scene_bands",
                             "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "scene_tiles_per_s":
            m["workloads"].append("swintiny.scene_bands")
    man["per_layer"].append({"name": "tiles.scene", "unit": "tiles",
                             "better": "higher", "source": "host_clock",
                             "layer": "engine",
                             "moves": "scene_tiles_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    b = harness.bench_for(root, "swintiny.scene_bands", SEED, 1.0, True,
                          "cpu")
    result, _ = harness.run(b, time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["tiles.scene"]["value"] > 0
    assert "swin_attn_roofline.scene" not in result["metrics"]
    b = harness.bench_for(root, "swintiny.scene_bands", SEED, 1.0, False,
                          "cpu")
    result, _ = harness.run(b, time.perf_counter())
    assert set(result["metrics"]) == {"scene_tiles_per_s", "setup_s"}


def test_scene_run_on_the_cpu():
    result, checks = run_cpu("swinunet.scene", trace=True)
    assert set(checks) == {"label_gap"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert "mfu.scene" in result["metrics"]


def test_scene_answer_altered_where_produced(monkeypatch):
    from cvcs_tpu_torch.infer.engine import SceneSegmenter

    forward_labels = SceneSegmenter._forward_labels

    def altered(self, wins):
        lab = forward_labels(self, wins)
        lab[0] = (lab[0] + 1) % self.cfg.num_classes
        return lab

    monkeypatch.setattr(SceneSegmenter, "_forward_labels", altered)
    result, checks = run_cpu("unetv2.scene")
    assert not result["correct"]
    assert checks["label_gap"][0] > checks["label_gap"][1]


@pytest.mark.parametrize("augmentation", [True, "fused"])
def test_train_run_on_the_cpu(augmentation):
    b = harness.bench_for(ROOT, "unetv2.train", SEED, 2.0, False, "cpu",
                          traffic=traffic_of("unetv2.train",
                                             augmentation=augmentation))
    result, checks = harness.run(b, time.perf_counter())
    names = {k for k, _, _ in checks}
    assert names == {"image_diff", "mask_diff", "loss_gap", "grad_gap",
                     "update_gap"}
    values = {k: v for k, v, _ in checks}
    assert values["image_diff"] == 0 and values["mask_diff"] == 0
    assert result["attempted"] > 0 and result["failed"] == 0


def test_train_state_left_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.SGD, "step", lambda self, *a, **k: None)
    result, checks = run_cpu("unetv2.train")
    assert not result["correct"]
    assert checks["update_gap"][0] > checks["update_gap"][1]


def test_train_half_the_batch_left_out(monkeypatch):
    from cvcs_tpu_torch.train import step as step_lib

    train_step = step_lib.train_step

    def half(state, loss_fn, image, mask, **kw):
        n = image.shape[0] // 2
        return train_step(state, loss_fn, image[:n], mask[:n], **kw)

    monkeypatch.setattr(step_lib, "train_step", half)
    result, checks = run_cpu("unetv2.train")
    assert not result["correct"]
    assert any(checks[k][0] > checks[k][1]
               for k in ("loss_gap", "grad_gap", "update_gap"))


def test_train_answer_altered_where_produced(monkeypatch):
    from cvcs_tpu_torch.data.loader import ChunkLoader

    get_chunk = ChunkLoader.get_chunk

    def altered(self, *a, **k):
        chunk = get_chunk(self, *a, **k)
        chunk.masks[0, 0, 0] = (chunk.masks[0, 0, 0] + 1) % 16
        return chunk

    monkeypatch.setattr(ChunkLoader, "get_chunk", altered)
    result, checks = run_cpu("unetv2.train")
    assert not result["correct"]
    assert checks["mask_diff"][0] == 1 > checks["mask_diff"][1]


@pytest.mark.parametrize("cell,number", [("unetv2.scene", "label_gap"),
                                         ("unetv2.train", "loss_gap")])
def test_the_control_reads_above_the_program(cell, number):
    """The control (the reference in float8 in the program's place), kept
    at a size a test run holds; the chip readings at the cells' sizes are
    in PERF.md."""
    from portbench import controls

    read = {}
    for mode in ("program", "control"):
        b = harness.bench_for(ROOT, cell, SEED, 0.0, False, "cpu",
                              traffic=traffic_of(cell))
        read[mode] = controls.reading(b, mode)
    assert read["control"][number] > 3 * read["program"][number]
