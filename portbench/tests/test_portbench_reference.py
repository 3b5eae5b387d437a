"""Each configuration's plain reference against the port's model at a
small input on the CPU, with the benchmark's weights in both; the
control (float8 operands) lies farther from the reference than the
port's bfloat16 forward."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from portbench import harness, weights

ROOT = Path(__file__).resolve().parents[2]
SEED = 2_345_678_901


def _setup(name, dtype):
    from cvcs_tpu_torch.models import build_model

    cfg = json.loads((ROOT / "portbench/configs" / f"{name}.json").read_text())
    ref = harness.load_module(ROOT / "portbench/reference" / f"{name}.py")
    w = weights.make_weights(ref.param_specs(cfg), SEED, "cpu")
    model, _ = build_model(cfg["net"], cfg["num_classes"], device="cpu",
                           dtype=dtype)
    weights.load_into(model, w)
    n = sum(v.numel() for k, v in w.items()
            if not k.endswith(("running_mean", "running_var")))
    assert n == cfg["parameters"] == sum(p.numel()
                                         for p in model.parameters())
    return cfg, ref, w, model


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name,size", [("unetv2", 32), ("swinunet", 64)])
def test_reference_equals_the_port_in_f32(name, size, train):
    cfg, ref, w, model = _setup(name, torch.float32)
    x = torch.randint(0, 256, (2, size, size, 3),
                      generator=torch.Generator().manual_seed(1)).float()
    model.train(train)
    with torch.no_grad():
        got = model(x)
        want = ref.forward(w, x, cfg, train=train)
    assert got.shape == want.shape == (2, size, size, cfg["num_classes"])
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


@pytest.mark.parametrize("name,size", [("unetv2", 32), ("swinunet", 64)])
def test_the_control_is_farther_than_bf16(name, size):
    cfg, ref, w, model = _setup(name, torch.bfloat16)
    x = torch.randint(0, 256, (2, size, size, 3),
                      generator=torch.Generator().manual_seed(2)).float()
    with torch.no_grad():
        bf16 = model.eval()(x)
        want = ref.forward(w, x, cfg)
        fp8 = ref.forward(w, x, cfg, prec="fp8")
    err_bf16 = (bf16 - want).abs().max()
    err_fp8 = (fp8 - want).abs().max()
    assert err_fp8 > 3 * err_bf16


def test_weights_are_the_seeds():
    spec = [("a.weight", (4, 3, 3, 3), "weight", 27),
            ("a.bias", (4,), "bias", 0), ("n.weight", (4,), "norm_w", 0),
            ("n.running_var", (4,), "var", 0)]
    one = weights.make_weights(spec, SEED, "cpu")
    two = weights.make_weights(spec, SEED, "cpu")
    other = weights.make_weights(spec, SEED + 1, "cpu")
    assert all(torch.equal(one[k], two[k]) for k in one)
    assert not torch.equal(one["a.weight"], other["a.weight"])
    assert torch.equal(one["n.running_var"], torch.ones(4))
    assert weights.stream_seed(SEED, "a") != weights.stream_seed(SEED, "b")
    assert 0 <= weights.stream_seed(2**40 + 5, "weights") < 2**63
