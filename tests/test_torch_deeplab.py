"""The port's DeepLab family against the JAX package's, on the CPU, from
the same numpy inputs and the same weights (carried by
``cvcs_tpu_torch.weights.deeplab_state_dict``).

* ASPP alone on a 48 x 48 map of 32 channels, so that every atrous tap of
  rates 12/24/36 reads real data (on a 4 x 4 map only the centre taps
  would, and a dropped dilation would not show).
* Eval-mode logits, batch 2: Resnet50 at p 64 (stage 4's dilation-4 taps
  inside its 8 x 8 map) and MobileNet at p 128 (the dilated stage's 5 x 5
  taps inside its 8 x 8 map), in f32 and bf16; MobileNetGoogle at p 36
  and 44 (its ceil-mode pools meet odd sizes: 9, 11, 5); MobileNetResnet18
  at p 64; Resnet101 on a blocky 64 x 64 scene, batch 2, whose bf16
  labels must agree with its f32 labels about as often as JAX's do.
* A train-mode forward and the gradient of a scalar loss, with JAX's ASPP
  dropout mask fed to the port: the loss, every gradient and every
  updated BatchNorm running statistic, for Resnet50 and MobileNet
  (momentum 0.01, eps 1e-3) at batch 2, and MobileNet at batch 1, a
  ``grad_accum`` micro-batch of one, where the pooling branch's BN sees
  n = 1.
* Resnet101's JAX tree (``jax.eval_shape``, nothing compiled) through the
  bridge is exactly the port's state dict, 58,629,712 parameters;
  ``export_deeplab``'s output for resnet101, resnet50 and mobilenet loads
  with ``strict=True``; the registry's fields equal JAX's and ``remat``
  is refused.
* Weight decay on a parameter that gets no gradient: after SGD2 steps it
  moves as optax's ``build_optimizer("SGD2")`` moves it on a zero
  gradient, on a tiny module and on MobileNetGoogle's ``aux_layer``.

Tolerances: f32 1e-4 * max(1, |ref|max) per tensor (only summation orders
differ); bf16 5e-2 * scale (the frameworks round at different points);
gradients 1e-4 of each gradient's largest element, floored at 1e-6 of the
largest of all, as in ``tests/test_torch_segformer.py``; the decayed
parameters within 2 f32 ulps of optax's, their momentum 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from cvcs_tpu.models import deeplab as jdl
from cvcs_tpu.models.registry import MODEL_REGISTRY as JAX_REGISTRY
from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu.train.optim import build_optimizer as jax_build_optimizer
from cvcs_tpu.utils.torch_export import export_deeplab
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.models import deeplab as tdl
from cvcs_tpu_torch.models import registry as tregistry
from cvcs_tpu_torch.models.blocks import conv_nhwc
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step
from cvcs_tpu_torch.weights import (aspp_state_dict, deeplab_state_dict,
                                    load_jax_variables)
from test_torch_segformer import _close, _numpy_variables

TOL = {"f32": 1e-4, "bf16": 5e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
NUM_CLASSES = 16
NAMES = ("Resnet101", "Resnet50", "MobileNet", "MobileNetGoogle",
         "MobileNetResnet18")
BACKBONE = dict(zip(NAMES, ("resnet101", "resnet50", "mobilenet",
                            "googlenet", "resnet18")))
PARAMETERS = {"Resnet101": 58_629_712, "Resnet50": 39_637_584,
              "MobileNet": 11_024_192, "MobileNetGoogle": 12_133_560,
              "MobileNetResnet18": 20_775_480}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shapes(model, p: int, channels: int = 3):
    return jax.eval_shape(
        lambda: model.init({"params": jax.random.key(0)},
                           jnp.zeros((1, p, p, channels), jnp.float32),
                           train=False))


_VARIABLES: dict = {}


def _jvars(name: str) -> dict:
    """Numpy-drawn JAX variables of a zoo net (the shapes do not depend on
    the input size), made once per worker."""
    if name not in _VARIABLES:
        model, _ = jax_build_model(name, NUM_CLASSES, dtype=jnp.float32)
        _VARIABLES[name] = _numpy_variables(_shapes(model, 32), seed=0)
    return _VARIABLES[name]


def _images(p: int, batch: int = 2, seed: int = 1, channels: int = 3):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, p, p, channels)).astype(np.float32)


def _port(name: str, dtype=torch.float32):
    """The port's net with the JAX variables (f64 parameters for an f64
    compute dtype), in eval mode."""
    model = tregistry.MODEL_REGISTRY[name].build(NUM_CLASSES, dtype=dtype)
    return load_jax_variables(model.to(torch.promote_types(
        dtype, torch.float32)), _jvars(name)).eval()


def _jax_forward(name: str, x, dtype=jnp.float32):
    model, _ = jax_build_model(name, NUM_CLASSES, dtype=dtype)
    return np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        _jvars(name), jnp.asarray(x)))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_aspp_matches_jax(precision):
    jdt, tdt = DTYPES[precision]
    x = np.random.default_rng(2).normal(size=(2, 48, 48, 32)).astype(
        np.float32)
    jmodel = jdl.ASPP(dtype=jdt)
    variables = _numpy_variables(_shapes(jmodel, 48, 32), seed=3)
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, jnp.asarray(x, jdt)).astype(jnp.float32))
    port = tdl.ASPP(32)
    port.load_state_dict(aspp_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == (2, 48, 48, 256)
    _close(got, want, TOL[precision], f"{precision} ASPP")


@pytest.mark.parametrize("hw", [(40, 52), (17, 30)])
def test_aspp_batch_one_runs_dense_phase_convs(hw, monkeypatch):
    """Repair: at batch 1 (a fullconv band) the atrous branches run as
    dense 3x3 convs over the rate's phase maps, never as a dilated conv,
    whose cuDNN path takes its direct kernel there (seconds a conv on the
    H100); at batch 2 (the window path) they stay dilated convs. The
    batch-1 output equals the batch-2 one's first image (f64)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(2, *hw, 32)))
    port = tdl.ASPP(32).eval()
    with torch.no_grad():
        for prm in port.parameters():
            prm.copy_(torch.from_numpy(rng.normal(size=prm.shape) * 0.2))
    dilations = []
    conv2d = torch.nn.functional.conv2d

    def spy(inp, weight, bias=None, stride=1, padding=0, dilation=1,
            groups=1):
        dilations.append((inp.shape[0], dilation))
        return conv2d(inp, weight, bias, stride, padding, dilation, groups)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    with torch.no_grad():
        one = port(x[:1])
        assert all(d in (1, (1, 1)) for _, d in dilations), dilations
        two = port(x)
    assert {d for _, d in dilations} >= {(12, 12), (24, 24), (36, 36)}
    assert one.shape == (1, *hw, 256)
    np.testing.assert_allclose(one.numpy(), two[:1].numpy(), rtol=0,
                               atol=1e-12)
    monkeypatch.undo()
    conv = port.convs[1][0]                     # rate 12, also at batch 2
    with torch.no_grad():
        np.testing.assert_allclose(
            tdl.phase_conv(x, conv).numpy(),
            conv_nhwc(x, conv, padding=12).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name,p,precision", [
    ("Resnet50", 64, "f32"), ("Resnet50", 64, "bf16"),
    ("MobileNet", 128, "f32"), ("MobileNet", 128, "bf16"),
    ("MobileNetGoogle", 36, "f32"), ("MobileNetGoogle", 44, "f32"),
    ("MobileNetResnet18", 64, "f32")])
def test_forward_matches_jax(name, p, precision):
    jdt, tdt = DTYPES[precision]
    x = _images(p)
    want = _jax_forward(name, x, jdt)
    with torch.no_grad():
        got = _port(name, tdt)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, p, p, NUM_CLASSES)
    _close(got, want, TOL[precision], f"{name} p {p} {precision} logits")


def test_resnet101_forward_and_bf16_agreement_match_jax():
    """Resnet101 on a blocky 64 x 64 scene, batch 2: the f32 logits agree
    with JAX's, and the port's bf16 labels agree with its f32 labels at
    least as often as JAX's bf16 labels agree with JAX's f32 ones, less
    one point (random weights leave some pixels' logits within bf16
    rounding of a tie)."""
    rng = np.random.default_rng(4)
    base = rng.integers(0, 256, (2, 5, 5, 3)).astype(np.uint8)
    x = (np.repeat(np.repeat(base, 16, 1), 16, 2)[:, :64, :64] // 2
         + rng.integers(0, 64, (2, 64, 64, 3))).astype(np.float32)
    out = {}
    for precision, (jdt, tdt) in DTYPES.items():
        out[f"jax {precision}"] = _jax_forward("Resnet101", x, jdt)
        with torch.no_grad():
            out[f"port {precision}"] = _port("Resnet101", tdt)(
                torch.from_numpy(x)).numpy()
    _close(out["port f32"], out["jax f32"], TOL["f32"], "Resnet101 logits")
    labels = {k: v.argmax(-1) for k, v in out.items()}
    jax_share = float((labels["jax bf16"] == labels["jax f32"]).mean())
    port_share = float((labels["port bf16"] == labels["port f32"]).mean())
    print(f"Resnet101 bf16 labels equal to f32 labels: JAX {jax_share:.4%}, "
          f"port {port_share:.4%}")
    assert port_share >= jax_share - 0.01


@pytest.mark.parametrize("name,batch", [("Resnet50", 2), ("MobileNet", 1)])
def test_train_gradient_matches_jax(name, batch):
    """Train mode, in f64 on both sides: BN on batch statistics (the
    running ones updated), dropout with JAX's own mask."""
    p = 64
    x = _images(p, batch, seed=5).astype(np.float64)
    proj = np.random.default_rng(6).normal(size=(batch, p, p, NUM_CLASSES))
    with jax.enable_x64(True):
        jvars = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       _jvars(name))
        model, _ = jax_build_model(name, NUM_CLASSES, dtype=jnp.float64,
                                   param_dtype=jnp.float64)

        def loss_fn(params):
            out, mutated = model.apply(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                jnp.asarray(x), train=True,
                mutable=["batch_stats", "intermediates"],
                rngs={"dropout": jax.random.key(3)},
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, fnn.Dropout))
            return jnp.mean(out * proj), mutated

        (jloss, mutated), jgrads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jvars["params"])
        jloss = float(jloss)
        dropped = np.asarray(mutated["intermediates"]["DeepLabHead_0"][
            "ASPP_0"]["Dropout_0"]["__call__"][0])
        want = jax.tree_util.tree_map(np.asarray, {
            "params": jgrads, "batch_stats": mutated["batch_stats"]})
    keep = dropped != 0
    assert keep.any() and not keep.all()     # ReLU zeros and dropped ones
    want = deeplab_state_dict(want, BACKBONE[name])

    port = _port(name, torch.float64).train()
    port.classifier[0].project[3].keep_mask = torch.from_numpy(keep)
    loss = (port(torch.from_numpy(x)) * torch.from_numpy(proj)).mean()
    loss.backward()
    np.testing.assert_allclose(float(loss), jloss, rtol=1e-5)

    grads = dict(port.named_parameters())
    top = max(float(want[k].abs().max()) for k in grads)
    for pname, param in grads.items():
        ref = want[pname].numpy()
        tol = max(1e-4 * float(np.abs(ref).max()), 1e-6 * top)
        np.testing.assert_allclose(param.grad.numpy(), ref, rtol=0, atol=tol,
                                   err_msg=pname)
    stats = {k: v for k, v in port.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert len(stats) > 100
    for k, v in stats.items():
        _close(v, want[k], TOL["f32"], k)


def test_resnet101_structure_matches_jax():
    """Full width without compiling: the bridge maps the JAX tree 1:1 onto
    the port's state dict, and ``export_deeplab`` writes the same names."""
    jmodel, _ = jax_build_model("Resnet101", NUM_CLASSES)
    shapes = _shapes(jmodel, 32)
    n_jax = sum(int(np.prod(s.shape))
                for s in jax.tree_util.tree_leaves(shapes["params"]))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    mapped = deeplab_state_dict(zeros, "resnet101")
    with torch.device("meta"):
        port = tregistry.MODEL_REGISTRY["Resnet101"].build(NUM_CLASSES)
    sd = port.state_dict()
    assert set(mapped) == set(sd)
    for k, v in sd.items():
        assert tuple(mapped[k].shape) == tuple(v.shape), k
    n_port = sum(p.numel() for p in port.parameters())
    assert n_jax == n_port == PARAMETERS["Resnet101"]
    exported = export_deeplab(zeros, "resnet101")
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in exported.items()}, strict=True)


@pytest.mark.parametrize("name", ["Resnet50", "MobileNet"])
def test_export_deeplab_loads_strict(name):
    jvars = _jvars(name)
    exported = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_deeplab(jvars, BACKBONE[name]).items()}
    with torch.device("meta"):
        model = tregistry.MODEL_REGISTRY[name].build(NUM_CLASSES)
    model.load_state_dict(exported, strict=True, assign=True)
    bridged = deeplab_state_dict(jvars, BACKBONE[name])
    assert set(bridged) == set(exported)
    for k, v in model.state_dict().items():
        assert torch.equal(v, bridged[k]), k


def test_registry_matches_jax():
    for name in NAMES:
        spec, jspec = tregistry.MODEL_REGISTRY[name], JAX_REGISTRY[name]
        for field in ("requires_context", "returns_logits", "wrapper",
                      "stride_product"):
            assert getattr(spec, field) == getattr(jspec, field), (name, field)
        assert spec.wrapper and spec.stride_product == 1
        with torch.device("meta"):
            model = spec.build(NUM_CLASSES)
        assert sum(p.numel() for p in model.parameters()) == PARAMETERS[name]
        with pytest.raises(ValueError, match="remat"):
            common.build_net(dict(net=name, remat=True), "cpu")
    with pytest.raises(ValueError, match="member checkpoints"):
        build_model("Ensemble", NUM_CLASSES, device="cpu")


class _HalfUsed(torch.nn.Module):
    """One parameter the loss reaches and one it does not."""

    def __init__(self):
        super().__init__()
        self.used = torch.nn.Parameter(torch.tensor([0.5, -1.25]))
        self.unused = torch.nn.Parameter(torch.tensor([1.5, -1.75, 0.99, 3.0]))

    def forward(self, x):
        return x * self.used.sum()


def _optax_sgd2(p0: np.ndarray, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX step's update of a parameter on zero gradients: (the
    parameter, its momentum trace) after ``steps`` SGD2 steps at epoch 0."""
    bundle = jax_build_optimizer("SGD2")
    lr = jnp.float32(bundle.lr_for_epoch(0))
    params = {"p": jnp.asarray(p0)}
    state = bundle.init(params)
    for _ in range(steps):
        updates, state = bundle.tx.update(
            jax.tree_util.tree_map(jnp.zeros_like, params), state, params)
        params = jax.tree_util.tree_map(lambda p, u: p - lr * u, params,
                                        updates)
    trace = [s for s in state if isinstance(s, optax.TraceState)][0].trace
    return np.asarray(params["p"]), np.asarray(trace["p"])


def _ulps(a: np.ndarray) -> np.ndarray:
    return np.spacing(np.abs(a).astype(np.float32))


def test_unused_parameter_is_decayed_as_optax_does():
    model = _HalfUsed()
    p0 = model.unused.detach().numpy().copy()
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    x = torch.ones(1, 2, 2, 1, dtype=torch.uint8)
    for _ in range(3):
        train_step(state, lambda out, mask: out.mean(), x, None)
    want, trace = _optax_sgd2(p0, 3)
    got = model.unused.detach().numpy()
    assert (got != p0).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2 * _ulps(want).max())
    np.testing.assert_allclose(
        opt.opt.state[model.unused]["momentum_buffer"].numpy(), trace,
        rtol=1e-6)
    assert state.unused == [model.unused]


def test_mobilenet_google_aux_layer_is_decayed():
    """The DeepLab head never reads GoogLeNet's ``aux_layer``: one SGD2
    step moves it by optax's decay alone."""
    model, _ = build_model("MobileNetGoogle", NUM_CLASSES, device="cpu",
                           dtype=torch.float32)
    aux = model.backbone.aux_layer
    start = {k: v.detach().numpy().copy() for k, v in aux.named_parameters()}
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    image = torch.from_numpy(_images(36, seed=7)).to(torch.uint8)
    mask = torch.from_numpy(np.random.default_rng(8).integers(
        0, NUM_CLASSES, (2, 36, 36)))

    def loss_fn(logits, target):
        return torch.nn.functional.cross_entropy(logits.permute(0, 3, 1, 2),
                                                 target)

    train_step(state, loss_fn, image, mask)
    for k, param in aux.named_parameters():
        want, trace = _optax_sgd2(start[k], 1)
        np.testing.assert_allclose(param.detach().numpy(), want, rtol=0,
                                   atol=2 * _ulps(want).max(), err_msg=k)
        np.testing.assert_allclose(opt.opt.state[param]["momentum_buffer"]
                                   .numpy(), trace, rtol=1e-6, err_msg=k)
    assert {id(p) for p in state.unused} == {id(p) for p in aux.parameters()}
