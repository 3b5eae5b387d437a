"""The port's SegFormer against the JAX package's, on the CPU, from the
same numpy inputs and the same weights (carried by
``cvcs_tpu_torch.weights.segformer_state_dict``).

* A tiny MiT (depths 1/1/1/1, widths 16/32/40/64, heads 1/2/5/8, decoder
  32; every layer of the full model, so every name of the weight bridge)
  at p 64, batch 2: eval-mode logits in f32 and bf16; at p 68, where the
  K/V reduction convs are VALID on maps that do not divide by their
  stride; and on a 4-band input, whose fourth band is ignored.
* A train-mode forward and the gradient of a scalar loss, with JAX's
  dropout mask (captured from its ``nn.Dropout`` output: nonzero means
  kept) fed to the port's head: the loss, every parameter's gradient and
  the head's updated BatchNorm running statistics.
* SegformerMod (MiT-B3) at full width: the JAX initialiser's shapes
  (``jax.eval_shape``, nothing compiled) through the bridge's key mapping
  are exactly the port's state-dict keys and shapes, and both hold
  47,257,600 parameters; and on a blocky 128 x 128 scene, batch 2, with
  random weights, the f32 logits agree with JAX's, and the port's bf16
  labels agree with its f32 labels at least as often as JAX's bf16
  labels agree with JAX's f32 ones, less one point (both near 98.5%:
  random weights leave the 16 logits within bf16 rounding of a tie at
  some pixels).
* ``export_segformer``'s output loading with ``strict=True``; the
  registry names; the depthwise conv's fan-in; ``remat`` refused; seeded
  dropout (a seed and a step give one mask, eval mode draws nothing, and
  two train steps from one seed give the same loss).

Tolerances: f32 1e-4 * max(1, |ref|max) per tensor (only summation orders
differ); bf16 5e-2 * scale (the frameworks round at different points);
gradients 1e-4 of each gradient's largest element, floored at 1e-6 of
the largest of all (a gradient that is zero but for rounding has no scale
of its own: the attention key's bias, which the softmax cancels, and the
head's per-stage biases, which its train-mode BatchNorm cancels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from cvcs_tpu.models import segformer as jsf
from cvcs_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu.utils.torch_export import export_segformer
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.models import blocks, build_model
from cvcs_tpu_torch.models import registry as tregistry
from cvcs_tpu_torch.models import segformer as tsf
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import loss_step, train_step
from cvcs_tpu_torch.weights import load_jax_variables, segformer_state_dict

TOL = {"f32": 1e-4, "bf16": 5e-2}
NUM_CLASSES = 16
P, BATCH = 64, 2
TINY = dict(depths=(1, 1, 1, 1), hidden_sizes=(16, 32, 40, 64),
            num_heads=(1, 2, 5, 8), decoder_dim=32)
B3_PARAMETERS = 47_257_600


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _jax_model(dtype=jnp.float32):
    return jsf.SegFormer(NUM_CLASSES, jsf.MiTConfig(**TINY), dtype=dtype)


def _numpy_variables(shapes, seed: int) -> dict:
    """JAX variables of the given shapes from numpy draws: kernels with
    std sqrt(1/fan_in), small nonzero biases, LayerNorm / BatchNorm
    scales near 1, BN running statistics off 0 / 1 (so eval mode reads
    them). Nothing is compiled."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _shapes(model, p: int = P):
    return jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0)},
                           jnp.zeros((1, p, p, 3), jnp.float32), train=False))


@pytest.fixture(scope="module")
def jvars():
    return _numpy_variables(_shapes(_jax_model()), seed=0)


def _port(jvars, dtype=torch.float32):
    model = tsf.SegFormer(NUM_CLASSES, tsf.MiTConfig(**TINY), dtype=dtype)
    return load_jax_variables(model, jvars).eval()


def _images(p=P, bands=3, seed=1):
    return np.random.default_rng(seed).integers(
        0, 256, (BATCH, p, p, bands)).astype(np.float32)


def _jax_forward(jvars, x, dtype=jnp.float32):
    model = _jax_model(dtype)
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        jvars, jnp.asarray(x)))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_forward_matches_jax(jvars, precision):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[precision]
    x = _images()
    want = _jax_forward(jvars, x, jdt)
    with torch.no_grad():
        got = _port(jvars, tdt)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, P, P, 16)
    _close(got, want, TOL[precision], f"{precision} logits")


def test_non_divisible_size_matches_jax(jvars):
    """p 68: stage maps 17/9/5/3, so the sr 8/4/2 convs drop a remainder
    (VALID); a SAME-padded conv would add a K/V row and column."""
    x = _images(p=68, seed=2)
    want = _jax_forward(jvars, x)
    with torch.no_grad():
        got = _port(jvars)(torch.from_numpy(x))
    assert got.shape == (BATCH, 68, 68, 16)
    _close(got, want, TOL["f32"], "p 68 logits")


def test_four_band_input_reads_three(jvars):
    x4 = _images(bands=4, seed=3)
    want = _jax_forward(jvars, x4)
    model = _port(jvars)
    with torch.no_grad():
        got = model(torch.from_numpy(x4))
        three = model(torch.from_numpy(x4[..., :3].copy()))
    _close(got, want, TOL["f32"], "4-band logits")
    assert torch.equal(got, three)


def test_train_gradient_matches_jax(jvars):
    """Train mode: BN on batch statistics, dropout with JAX's own mask."""
    x = _images(seed=4)
    proj = np.random.default_rng(5).normal(
        size=(BATCH, P, P, NUM_CLASSES)).astype(np.float32)
    model = _jax_model()

    def loss_fn(params):
        out, mutated = model.apply(
            {"params": params, "batch_stats": jvars["batch_stats"]},
            jnp.asarray(x), train=True,
            mutable=["batch_stats", "intermediates"],
            rngs={"dropout": jax.random.key(3)},
            capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
        return jnp.mean(out * proj), mutated

    (jloss, mutated), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jvars["params"])
    dropped = np.asarray(mutated["intermediates"]["SegFormerHead_0"][
        "Dropout_0"]["__call__"][0])
    keep = dropped != 0
    assert keep.any() and not keep.all()     # ReLU zeros and dropped ones
    want = segformer_state_dict(
        jax.tree_util.tree_map(np.asarray, {
            "params": jgrads, "batch_stats": mutated["batch_stats"]}),
        TINY["depths"])

    port = _port(jvars).train()
    port.decode_head.dropout.keep_mask = torch.from_numpy(keep)
    loss = (port(torch.from_numpy(x)) * torch.from_numpy(proj)).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)

    grads = dict(port.named_parameters())
    top = max(float(want[k].abs().max()) for k in grads)
    for name, p in grads.items():
        ref = want[name].numpy()
        tol = max(1e-4 * float(np.abs(ref).max()), 1e-6 * top)
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=name)
    for stat in ("running_mean", "running_var"):
        _close(getattr(port.decode_head.batch_norm, stat),
               want[f"decode_head.batch_norm.{stat}"], TOL["f32"], stat)


def test_segformer_mod_structure_matches_jax():
    """Full-width MiT-B3 without compiling: the bridge maps the JAX tree
    1:1 onto the port's state dict."""
    jmodel, _ = jax_build_model("SegformerMod", NUM_CLASSES)
    shapes = _shapes(jmodel)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    mapped = segformer_state_dict(zeros)
    with torch.device("meta"):
        port = tregistry.MODEL_REGISTRY["SegformerMod"].build(NUM_CLASSES)
    sd = port.state_dict()
    assert set(mapped) == set(sd)
    for k, v in sd.items():
        assert tuple(mapped[k].shape) == tuple(v.shape), k
    n_port = sum(p.numel() for p in port.parameters())
    assert n_jax == n_port == B3_PARAMETERS


def test_segformer_mod_bf16_agreement_matches_jax():
    rng = np.random.default_rng(1)
    base = rng.integers(0, 256, (BATCH, 9, 9, 3)).astype(np.uint8)
    x = (np.repeat(np.repeat(base, 16, 1), 16, 2)[:, :128, :128] // 2
         + rng.integers(0, 64, (BATCH, 128, 128, 3))).astype(np.float32)
    j32, _ = jax_build_model("SegformerMod", NUM_CLASSES, dtype=jnp.float32)
    j16, _ = jax_build_model("SegformerMod", NUM_CLASSES, dtype=jnp.bfloat16)
    variables = _numpy_variables(_shapes(j32), seed=0)
    out = {}
    for name, model in (("jax f32", j32), ("jax bf16", j16)):
        out[name] = np.asarray(jax.jit(
            lambda v, x, m=model: m.apply(v, x, train=False))(variables, x))
    for name, dt in (("port f32", torch.float32),
                     ("port bf16", torch.bfloat16)):
        model, _ = build_model("SegformerMod", NUM_CLASSES, device="cpu",
                               dtype=dt)
        with torch.no_grad():
            out[name] = load_jax_variables(model, variables)(
                torch.from_numpy(x)).numpy()
    _close(out["port f32"], out["jax f32"], TOL["f32"], "f32 logits")
    labels = {k: v.argmax(-1) for k, v in out.items()}
    jax_share = float((labels["jax bf16"] == labels["jax f32"]).mean())
    port_share = float((labels["port bf16"] == labels["port f32"]).mean())
    print(f"bf16 labels equal to f32 labels: JAX {jax_share:.4%}, port "
          f"{port_share:.4%}")
    assert port_share >= jax_share - 0.01


def test_export_segformer_loads_strict(jvars):
    exported = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_segformer(jvars, depths=TINY["depths"]).items()}
    model = tsf.SegFormer(NUM_CLASSES, tsf.MiTConfig(**TINY))
    model.load_state_dict(exported, strict=True)
    bridged = segformer_state_dict(jvars, TINY["depths"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, bridged[k]), k


def test_registry_names_match_jax():
    for name in ("SegformerMod", "SegformerB0", "SegformerB1"):
        spec, jspec = tregistry.MODEL_REGISTRY[name], JAX_REGISTRY[name]
        assert name in tregistry.MODEL_REGISTRY
        for field in ("requires_context", "returns_logits", "wrapper",
                      "stride_product"):
            assert getattr(spec, field) == getattr(jspec, field), (name, field)
        assert spec.stride_product == 4 and spec.wrapper
    b0, _ = build_model("SegformerB0", NUM_CLASSES, device="cpu")
    assert b0.config == tsf.MIT_B0 and not b0.training
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("SegformerMod", NUM_CLASSES)


def test_depthwise_fan_in_is_nine():
    model = blocks.init_weights(tsf.SegFormer(NUM_CLASSES, tsf.MIT_B0), 0)
    dw = model.segformer.encoder.block[3][0].mlp.dwconv.dwconv.weight
    assert dw.shape == (1024, 1, 3, 3)
    assert abs(float(dw.std()) - 1 / 3) < 0.02     # std sqrt(1/9)


def test_remat_refused():
    with pytest.raises(ValueError, match="remat"):
        common.build_net(dict(net="SegformerB0", remat=True), "cpu")


def test_dropout_is_seeded():
    drop = blocks.SeededDropout(0.1).train()
    x = torch.ones(4, 8, 8, 32)
    draws = []
    for step in (0, 0, 1):
        blocks.seed_dropout(drop, 0xD0, step)
        draws.append(drop(x))
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    kept = draws[0] != 0
    assert torch.equal(draws[0][kept],
                       torch.full_like(draws[0][kept], 1 / 0.9))
    drop.eval()
    drop.reseed(None)                 # eval mode draws nothing, seeded or not
    assert torch.equal(drop(x), x)


def test_train_steps_from_one_seed_repeat(jvars):
    x = torch.from_numpy(_images(seed=6)).to(torch.uint8)
    mask = torch.from_numpy(np.random.default_rng(7).integers(
        0, NUM_CLASSES, (BATCH, P, P)).astype(np.int64))

    def loss_fn(logits, target):
        return torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2),
                                                 target)

    def step(dropout_seed):
        model = _port(jvars)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        state = TrainState(model, opt, dropout_seed=dropout_seed)
        loss = float(train_step(state, loss_fn, x, mask))
        assert model.decode_head.dropout._gen is not None
        model.decode_head.dropout.reseed(None)
        float(loss_step(state, loss_fn, x, mask))     # eval: no draw
        assert model.decode_head.dropout._gen is None
        return loss

    first, again, other = step(0xD0), step(0xD0), step(0xD1)
    assert first == again
    assert first != other
