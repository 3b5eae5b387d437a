"""The port's UNet family against the JAX package's, on the CPU, from the
same numpy inputs and the same weights (carried by
``cvcs_tpu_torch.weights.unet_state_dict``).

* Unet, Unetv2 and Unetv2S2D eval-mode logits at p 64, batch 2 (the
  encoder widths are fixed at 64..1024, so the spatial size is what stays
  small), and Unetv2 in bf16;
* Unetv2 train-mode logits and BatchNorm running statistics;
* two f32 Unetv2 train steps (the recipe's wCEL with ignore_background,
  SGD2) against JAX ``make_train_step``: the loss of each step, then every
  parameter and running statistic;
* the helpers ``center_crop``, ``upsample_bilinear``, ``resize_bilinear``,
  ``resize_nearest``, space-to-depth / depth-to-space and ``ConvBNAct``
  against their JAX versions;
* ``export_unet``'s output loading with ``strict=True``;
* ``remat``: a rematerialised step equal to the plain one, with the BN
  running statistics updated once; ``remat: true`` on a Swin net raising
  ``ValueError``.

Tolerances: f32 1e-4 * max(1, |ref|max) per tensor (only summation orders
differ between the frameworks' convolutions); bf16 5e-2 * scale (the two
frameworks round at different points and an ulp propagates); helpers
1e-6 (the same arithmetic); remat against plain exact on the CPU (the
recomputation repeats the same kernels on the same values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models import blocks as jblocks
from cvcs_tpu.models import unet as junet
from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu.ops import losses as jlosses
from cvcs_tpu.ops import resize as jresize
from cvcs_tpu.train import build_optimizer as jax_build_optimizer
from cvcs_tpu.train.state import TrainState as JaxTrainState
from cvcs_tpu.train.step import make_train_step
from cvcs_tpu.utils.torch_export import export_unet
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.models import blocks, build_model
from cvcs_tpu_torch.models import unet as tunet
from cvcs_tpu_torch.ops import losses as tlosses
from cvcs_tpu_torch.ops import resize as tresize
from cvcs_tpu_torch.train.optim import build_optimizer
from cvcs_tpu_torch.train.state import TrainState
from cvcs_tpu_torch.train.step import train_step
from cvcs_tpu_torch.weights import load_jax_variables, unet_state_dict

TOL = {"f32": 1e-4, "bf16": 5e-2}
NUM_CLASSES = 16
P, BATCH = 64, 2
UPSAMPLE = {"Unet": "bilinear", "Unetv2": "transpose"}


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


def _init_variables(name):
    """JAX variables of ``name`` (init at 32 x 32; the parameters do not
    depend on the spatial size), BN running statistics moved off 0 / 1 so
    that eval mode reads them."""
    model, _ = jax_build_model(name, NUM_CLASSES, dtype=jnp.float32)
    v = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.key(0)},
        jnp.zeros((1, 32, 32, 3), jnp.float32), train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.default_rng(4)

    def move(node):
        if "mean" in node and "var" in node:
            node["mean"] = rng.normal(0, 0.2, node["mean"].shape).astype(
                np.float32)
            node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(
                np.float32)
        else:
            for child in node.values():
                move(child)

    move(v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def jvars():
    """name -> JAX variables, each initialised once per module."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _init_variables(name)
        return cache[name]

    return get


def _port(jvars, name, dtype=torch.float32, **kw):
    model, spec = build_model(name, NUM_CLASSES, device="cpu", dtype=dtype,
                              **kw)
    return load_jax_variables(model, jvars(name)), spec


def _images(seed=1, b=BATCH, px=P):
    return np.random.default_rng(seed).integers(
        0, 256, (b, px, px, 3)).astype(np.uint8)


@pytest.mark.parametrize("name,dtype", [
    ("Unet", "f32"), ("Unetv2", "f32"), ("Unetv2S2D", "f32"),
    ("Unetv2", "bf16")])
def test_unet_logits_match_jax(jvars, name, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = _images()
    jmodel, _ = jax_build_model(name, NUM_CLASSES, dtype=jdt)
    want = jax.jit(jmodel.apply)(jvars(name), jnp.asarray(x))
    model, spec = _port(jvars, name, tdt)
    got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and spec.stride_product in (16, 32)
    _close(got, np.asarray(want), TOL[dtype], f"{name} {dtype} logits")


def test_unetv2_train_mode_bn_matches_jax(jvars):
    x = _images(2)
    jmodel, _ = jax_build_model("Unetv2", NUM_CLASSES, dtype=jnp.float32)
    want, upd = jax.jit(
        lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"])
    )(jvars("Unetv2"), jnp.asarray(x))
    model, _ = _port(jvars, "Unetv2")
    got = model.train()(torch.from_numpy(x))
    _close(got, np.asarray(want), TOL["f32"], "train-mode logits")
    sd = unet_state_dict({"params": jvars("Unetv2")["params"],
                          "batch_stats": jax.device_get(upd["batch_stats"])})
    state = model.state_dict()
    for k, v in sd.items():
        if k.endswith(("running_mean", "running_var")):
            _close(state[k], v, 1e-5, k)


def test_unetv2_train_steps_match_jax(jvars):
    weights = np.random.default_rng(6).uniform(
        0.5, 2.0, NUM_CLASSES).astype(np.float32)
    weights[0] = 0.0
    variables = jvars("Unetv2")
    rng = np.random.default_rng(5)
    batches = [(_images(10 + i), rng.integers(0, NUM_CLASSES, (BATCH, P, P))
                .astype(np.int32)) for i in range(2)]

    jmodel, _ = jax_build_model("Unetv2", NUM_CLASSES, dtype=jnp.float32)
    jopt = jax_build_optimizer("SGD2")
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=jopt.init(params), apply_fn=jmodel.apply, tx=jopt.tx)
    jstep = make_train_step(jlosses.build_loss(
        "wCEL", weights=weights, ignore_background=True))
    lr = jnp.float32(jopt.lr_for_epoch(0))

    model, _ = _port(jvars, "Unetv2")
    opt = build_optimizer("SGD2", model.parameters())
    opt.set_epoch(0)
    state = TrainState(model, opt)
    loss_fn = tlosses.build_loss("wCEL", weights=weights,
                                 ignore_background=True)
    for i, (img, msk) in enumerate(batches):
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(msk),
                              jnp.zeros((), jnp.uint8), lr, jax.random.key(0))
        loss = train_step(state, loss_fn, torch.from_numpy(img),
                          torch.from_numpy(msk))
        assert np.isfinite(float(loss))
        _close(float(loss), float(jloss), TOL["f32"], f"loss at step {i + 1}")
    want = unet_state_dict({"params": jax.device_get(jstate.params),
                            "batch_stats": jax.device_get(jstate.batch_stats)})
    got = state.model.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            _close(got[k], v, TOL["f32"], f"{k} after step 2")


def _helper_cases():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 12, 5)).astype(np.float32)
    lab = rng.integers(0, 16, (2, 9, 12)).astype(np.int32)
    return {
        "center_crop": (lambda a: jblocks.center_crop(a, (5, 8)),
                        lambda a: blocks.center_crop(a, (5, 8)), x),
        "center_crop_int": (lambda a: jblocks.center_crop(a, 7),
                            lambda a: blocks.center_crop(a, 7), x),
        "upsample_bilinear": (lambda a: jresize.upsample_bilinear(a, 2),
                              lambda a: tresize.upsample_bilinear(a, 2), x),
        "upsample_bilinear_bf16": (
            lambda a: jresize.upsample_bilinear(a.astype(jnp.bfloat16), 2),
            lambda a: tresize.upsample_bilinear(a.to(torch.bfloat16), 2), x),
        "resize_bilinear_up": (lambda a: jresize.resize_bilinear(a, (13, 20)),
                               lambda a: tresize.resize_bilinear(a, (13, 20)),
                               x),
        "resize_bilinear_down": (lambda a: jresize.resize_bilinear(a, (4, 5)),
                                 lambda a: tresize.resize_bilinear(a, (4, 5)),
                                 x),
        "resize_nearest": (lambda a: jresize.resize_nearest(a, (20, 7)),
                           lambda a: tresize.resize_nearest(a, (20, 7)), lab),
        "space_to_depth": (lambda a: junet._space_to_depth(a[:, :8], 2),
                           lambda a: tunet.space_to_depth(a[:, :8], 2), x),
        "depth_to_space": (lambda a: junet._depth_to_space(a[..., :4], 2),
                           lambda a: tunet.depth_to_space(a[..., :4], 2), x),
    }


@pytest.mark.parametrize("case", list(_helper_cases()))
def test_helpers_match_jax(case):
    jfn, tfn, x = _helper_cases()[case]
    want = np.asarray(jfn(jnp.asarray(x)))
    got = tfn(torch.from_numpy(x))
    assert str(got.dtype).split(".")[-1] == str(want.dtype), case
    _close(got, want.astype(np.float32), 1e-6, case)


@pytest.mark.parametrize("train", [False, True])
def test_conv_bn_act_matches_jax(train):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    jblk = jblocks.ConvBNAct(6, dtype=jnp.float32)
    v = jblk.init(jax.random.key(1), jnp.asarray(x))
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"]["BatchNorm_0"]["mean"] = rng.normal(
        0, 0.3, 6).astype(np.float32)
    want = jblk.apply(v, jnp.asarray(x), train, mutable=["batch_stats"])[0]
    blk = blocks.ConvBNAct(3, 6)
    conv, bn = blk.layer
    with torch.no_grad():
        p = v["params"]
        conv.weight.copy_(torch.from_numpy(
            p["Conv_0"]["kernel"].transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(p["Conv_0"]["bias"]))
        bn.weight.copy_(torch.from_numpy(p["BatchNorm_0"]["scale"]))
        bn.bias.copy_(torch.from_numpy(p["BatchNorm_0"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(
            v["batch_stats"]["BatchNorm_0"]["mean"]))
    got = blk.train(train)(torch.from_numpy(x))
    assert got.shape == (2, 8, 8, 6)
    _close(got, np.asarray(want), 1e-5, f"train={train}")


@pytest.mark.parametrize("name", ["Unet", "Unetv2"])
def test_export_unet_loads_strict(jvars, name):
    variables = jvars(name)
    sd = export_unet(variables, upsample=UPSAMPLE[name])
    model, _ = build_model(name, NUM_CLASSES, device="cpu",
                           dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in sd.items()}, strict=True)
    ours = unet_state_dict(variables, UPSAMPLE[name])
    assert set(ours) == set(sd)
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), k)


def test_remat_step_equals_plain_step(jvars):
    img = torch.from_numpy(_images(3, px=32))
    msk = torch.from_numpy(np.random.default_rng(9).integers(
        0, NUM_CLASSES, (BATCH, 32, 32)).astype(np.int32))
    loss_fn = tlosses.build_loss("CEL")
    runs = []
    for remat in (False, True):
        model, _ = _port(jvars, "Unetv2", remat=remat)
        opt = build_optimizer("SGD2", model.parameters())
        opt.set_epoch(0)
        loss = train_step(TrainState(model, opt), loss_fn, img, msk)
        runs.append((float(loss), model.state_dict()))
    (plain_loss, plain), (remat_loss, rematted) = runs
    assert remat_loss == plain_loss
    for k, v in plain.items():
        assert torch.equal(rematted[k], v), k
    # updated once: 0.9 * the loaded statistic + 0.1 * the batch's
    first = jvars("Unetv2")["batch_stats"]["_Encoder_0"]["ConvBNAct_0"]
    moved = rematted["encode1.0.layer.1.running_mean"].numpy()
    assert not np.allclose(moved, first["BatchNorm_0"]["mean"])
    model, _ = _port(jvars, "Unetv2")
    with torch.no_grad():
        model.train()(img.float())
    np.testing.assert_array_equal(
        moved, model.state_dict()["encode1.0.layer.1.running_mean"].numpy())


def test_remat_on_a_net_without_it_raises():
    with pytest.raises(ValueError, match="remat: true is not supported for "
                                         "net 'SwinUnetTiny'"):
        common.build_net(dict(net="SwinUnetTiny", remat=True), "cpu")
    model, _, _ = common.build_net(dict(net="Unetv2", remat=True,
                                        precision="f32"), "cpu")
    assert all(blk.remat for level in range(1, 6)
               for blk in getattr(model, f"encode{level}")[-2:])
