"""The frozen counts equal ``chip_smoke.py``'s at the serving and training
shapes, and the Swin call list equals its per-forward table."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from portbench import counts

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "portbench/configs/swinunet.json").read_text())


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_peaks(smoke):
    assert counts.HBM_BYTES_PER_S == smoke.HBM_BYTES_PER_S
    assert counts.PEAK_FLOPS["bf16"] == smoke.PEAK_FLOPS[torch.bfloat16]
    assert counts.PEAK_FLOPS["f32"] == smoke.PEAK_FLOPS[torch.float32]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k1_bound(smoke, dtype, masked):
    tdt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    for case in smoke.K1_CASES + smoke.K1_BAND_CASES:
        for batch in (1, 10, 128):
            assert counts.k1_bound(case, dtype, masked, batch) == \
                pytest.approx(smoke.k1_bound(case, tdt, masked, batch),
                              rel=1e-12)


@pytest.mark.parametrize("masked", [False, True])
def test_k2_bound(smoke, masked):
    for case in smoke.K1_CASES:
        if not isinstance(case[1], int):
            continue
        assert counts.k2_bound(case, "bf16", masked, smoke.B_TRAIN) == \
            pytest.approx(smoke.k2_bound(case, torch.bfloat16, masked),
                          rel=1e-12)


def test_k5_bound(smoke):
    # chip_smoke.time_k5: b * 224 * 224 * 3 values read as uint8 and
    # written as f32, 12 f32 operations each
    for b in (smoke.B_CHUNK, smoke.B_GID15):
        nbytes = b * 224 * 224 * 3 * (1 + 4)
        ops = b * 224 * 224 * 3 * 12
        got = counts.k5_bound(b, 224, 3)
        assert got[0] == pytest.approx(nbytes / smoke.HBM_BYTES_PER_S * 1e3)
        assert got[1] == pytest.approx(
            ops / smoke.PEAK_FLOPS[torch.float32] * 1e3)


def test_serving_calls_are_the_smoke_table(smoke):
    cases = {c[0]: c for c in smoke.K1_CASES}
    want = []
    for name, n in smoke.K1_PER_FORWARD:
        c = cases[name]
        want += [(c[1:], c[6] > 0 or name.endswith("shift"))] * n
    got = [(c[1:], m) for c, m in counts.swin_attn_calls(CFG, 256)]
    assert sorted(got) == sorted(want)
    assert len(got) == 12


def test_training_calls():
    calls = counts.swin_attn_calls(CFG, 224)
    assert len(calls) == 12
    # 56 tokens are 7 windows; 28 and 14 are padded to 32 and 16 (masked);
    # stage 4 is one 7 x 7 window, unshifted and unmasked (chip_smoke's
    # t49 case)
    assert [c[1] for c, _ in calls] == [56] * 2 + [32] * 2 + [16] * 6 + [7] * 2
    assert [m for _, m in calls] == [False] + [True] * 9 + [False] * 2
    assert calls[-1][0][1:] == (7, 768, 24, 7, 7, 0)
