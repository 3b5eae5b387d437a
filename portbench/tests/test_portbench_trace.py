"""The metric arithmetic on a synthetic Chrome trace: the union of the
device's intervals, the idle gaps and what the host was doing in them,
the launch attribution, and the roofline and share readers."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import counts, harness, tracing

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "portbench/configs/swinunet.json").read_text())


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A window of 100 us: a scene span [8, 95) holding a forward span
    [10, 40) that launches two K1 kernels and a GEMM and a fetch span
    [60, 95) that launches a copy; idle [0, 12), [50, 65) and [80, 100)."""
    return {"traceEvents": [
        ev("user_annotation", "window", 0, 100),
        ev("user_annotation", "scene", 8, 87),
        ev("user_annotation", "forward", 10, 30),
        ev("user_annotation", "fetch", 60, 35),
        ev("cuda_runtime", "cudaLaunchKernel", 11, 1, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 13, 1, 3),
        ev("cuda_runtime", "cudaMemcpyAsync", 61, 1, 4),
        ev("kernel", "void swin_attn_fwd_gemm<1>(...)", 12, 18, 1),
        ev("kernel", "void swin_attn_fwd_core<1>(...)", 25, 10, 2),
        ev("kernel", "sm90_xmma_gemm_bf16", 35, 15, 3),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 65, 15, 4),
        ev("kernel", "before_the_window", -20, 10),
        ev("gpu_user_annotation", "forward", 10, 30),
    ]}


def test_union_and_gaps():
    iv = [(12, 30), (25, 35), (35, 50), (65, 80)]
    assert tracing.union_s(iv, 0, 100) == pytest.approx(53)
    assert tracing.union_s(iv, 20, 70) == pytest.approx(35)
    assert tracing.idle_gaps(iv, 0, 100) == [(0, 12), (50, 65), (80, 100)]
    assert tracing.idle_gaps([], 0, 10) == [(0, 10)]


def test_reduce_trace():
    s = tracing.reduce_trace(synthetic())
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(53e-6)
    spans = {name: span for name, _, span in s["gpu"]}
    assert spans["sm90_xmma_gemm_bf16"] == "forward"
    assert spans["Memcpy DtoH (Device -> Pageable)"] == "fetch"
    assert "before_the_window" not in spans
    # each idle stretch goes to the innermost span halfway through it:
    # [0, 12) to none, [50, 65) to the scene, [80, 100) to the fetch
    idle = s["idle_by_span"]
    assert idle == pytest.approx({"other": 12e-6, "scene": 15e-6,
                                  "fetch": 20e-6})
    assert tracing.device_seconds(s, "swin_attn_fwd") == pytest.approx(28e-6)


def test_breakdown_ranks_and_cuts():
    s = tracing.reduce_trace(synthetic())
    bd = tracing.breakdown(s, top=2)
    assert [n for n, _ in bd["device_ops"]] == [
        "void swin_attn_fwd_gemm<1>(...)", "sm90_xmma_gemm_bf16"]
    assert [n for n, _ in bd["idle_gaps"]] == ["fetch", "scene"]
    assert len(bd["idle_gaps"]) == 2


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")


def test_scene_readers():
    s = tracing.reduce_trace(synthetic())
    traffic = {"patch_size": 224, "border_correction": 256}
    calls = counts.swin_attn_calls(CFG, 256)
    r = {"trace": s, "sub": {"scenes": 1, "forwards": [128, 64],
                             "k1": 2 * len(calls)},
         "cfg": CFG, "traffic": traffic, "window_s": 2.0, "units": 960,
         "profiler_s": 0.5, "flops_per_unit": 1e9,
         "device_ms": {"forward": [30.0, 10.0]}, "host": {}}
    assert _reader("engine_ms.scene").read(r) == pytest.approx(15e-3)
    assert _reader("forward_ms.scene").read(r) == pytest.approx(20.0)
    assert _reader("device_idle.scene").read(r) == pytest.approx(47.0)
    assert _reader("mfu.scene").read(r) == pytest.approx(
        960e9 / 1.5 / 989e12 * 100)
    bound = (counts.swin_attn_bound_ms(CFG, 256, 128)
             + counts.swin_attn_bound_ms(CFG, 256, 64))
    assert _reader("swin_attn_roofline.scene").read(r) == pytest.approx(
        bound / 28e-3 * 100)
    # the counter halves the calls: the bound is scaled with it
    r["sub"]["k1"] = len(calls)
    assert _reader("swin_attn_roofline.scene").read(r) == pytest.approx(
        bound / 2 / 28e-3 * 100)


def test_readers_return_nothing_without_their_inputs():
    r = {"trace": None, "sub": {}, "device_ms": {}, "host": {},
         "window_s": 1.0, "units": 0, "cfg": CFG, "traffic": {}}
    for name in ("engine_ms.scene", "forward_ms.scene", "device_idle.scene",
                 "swin_attn_roofline.scene", "mfu.scene", "chunk_ms.train",
                 "step_ms.train", "device_idle.train", "mfu.train"):
        assert _reader(name).read(r) is None, name
    # a trace with no kernel of K1's holds nothing for its roofline
    empty = tracing.reduce_trace({"traceEvents": [
        ev("user_annotation", "window", 0, 10),
        ev("kernel", "other", 1, 2)]})
    r.update(trace=empty, sub={"forwards": [128], "k1": 12})
    assert _reader("swin_attn_roofline.scene").read(r) is None


def test_train_readers():
    trace = {"traceEvents": [
        ev("user_annotation", "window", 0, 1000),
        ev("kernel", "sm90_xmma_dgrad", 0, 400),
        ev("kernel", "batch_norm_backward", 300, 150)]}
    s = tracing.reduce_trace(trace)
    r = {"trace": s, "sub": {"steps": 1}, "cfg": CFG, "traffic": {},
         "device_ms": {"step": [40.0, 60.0]},
         "host": {"get_chunk": [0.2, 0.4]}, "window_s": 10.0,
         "profiler_s": 0.5, "units": 6400, "flops_per_unit": 5e10}
    assert _reader("step_ms.train").read(r) == pytest.approx(50.0)
    assert _reader("chunk_ms.train").read(r) == pytest.approx(300.0)
    assert _reader("device_idle.train").read(r) == pytest.approx(55.0)
    assert _reader("mfu.train").read(r) == pytest.approx(
        6400 * 5e10 / 9.5 / 989e12 * 100)
