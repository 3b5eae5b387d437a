"""Spatially partitioned training of the port on gloo ranks, against the
JAX package's single-device f32 step.

A spatial step must equal the single-device step: JAX's own pin for its
GSPMD spatial step (``tests/test_multidevice_train.py:99-139``) holds it
to the single-device one, and so does this file; no test here holds the
port against a JAX mesh configuration.

* Two launches of ``_torch_ranks.start``: world 2 (data 1 x spatial 2)
  and world 4 (data 2 x spatial 2). Each computes all its cases in one
  go; the JAX references run meanwhile, the DeepLab cases' in a helper
  process beside the pytest one, and the one-process ``cli.train``
  references in another.
* Steps (one SGD2 step at f32, global batch of 4, wCEL with
  ``ignore_background`` whose labels are mostly background in the top
  rows, so a per-rank normaliser would miss; the same numpy batch and
  the same carried weights as JAX's ``make_train_step``): Unet and
  Unetv2S2D at p 64; SwinUnetTiny at p 64 (stage 1's shifted windows
  wrap from the last rank to rank 0); SwinUnetTiny at p 96 (3 window rows
  over 2 ranks, stage 2's pad rows on the last rank, and stage 4's
  downsample on strips of 3 rows, which takes the gather); SegformerB0
  at p 64 with JAX's own dropout mask; the Unet step through
  ``build_fused_ce`` (K3 and K4's plain versions on each rank's rows)
  against the same JAX wCEL step, and the Unet step with ``remat`` at
  p 80 (level 4's strips of 5 rows are gathered before the pool, so level
  5's rematerialised blocks run whole; their recomputation in the
  backward must run whole again, or it would take halos and sum over
  every rank).
  World 2 runs all but the fused and remat steps, world 4 the
  SwinUnetTiny p 64, SegformerB0, fused and remat steps.
* DeepLab steps (the same rules; one numpy keep mask for the ASPP
  dropout on both sides, fed to JAX's step through
  ``flax.linen.intercept_methods``), at a global batch of 2: world 2
  runs MobileNet, MobileNetGoogle and Resnet50 at p 64
  and MobileNetResnet18 at p 96, where the ResNet-18 trunk's /32 map (3
  rows) does not split over two ranks, so its last stage runs whole and
  the upsample's 6 rows split again, as p 224 does on the card; world 4
  (data 2 x spatial 2) runs MobileNet's batch through
  ``build_fused_ce``, one image a data rank, which reaches the atrous
  branches' batch-1 path on strips. Resnet50 computes in f64 on both
  sides (see ``STEPS``). The loss within rtol 1e-5, every
  parameter and BatchNorm statistic within atol 1e-4 + rtol 1e-4, JAX's
  tolerance for its spatial step; every rank ends on one state. The ops
  that took the gather are the ones listed in ``GATHERS``.
* The halo: ``row_halo`` with counts that differ from rank to rank, in
  ring mode and with zeros at the ends, and ``gather_rows``, in f64:
  values and the gradients that come back to each rank equal autograd
  through slices of the whole tensor. A ring replaced by zeros fails
  ``test_ring_halo_wraps_the_last_rank_to_rank_0``. (The Swin steps
  cannot tell: the shifted windows' mask keeps the wrapped rows from
  every row the rank owns, so a zero halo gives the same step.) The
  inference halo (``exchange_row_halo``) wider than a strip takes the
  gather.
* ``cli.train`` with ``mesh: {spatial: 2}`` and ``device: cpu``: Unetv2
  (the recipe's model) at p 64, batch 8, an epoch of one step with
  validation and evaluation, then a resume for a second epoch with
  ``load_checkpoint: auto``: losses within 1e-5 x max(1, |ref|max) of
  one process's, the checkpoints within the steps' tolerance, the
  evaluation's confusion matrix on all but 0.1% of the pixels (labels at
  near-tie logits of the random weights may flip), and the ranks end on
  one state. One step an epoch: at batch 4 (two steps an epoch) the f32
  validation loss after them moves by 1.3e-5 relative between one
  process and two ranks, and by 1.3e-6 between one process on 1 and on 3
  threads; the same two steps in f64 agree to the loss's f32 rounding.
  The full-width U-Net's BatchNorm over 4 x 4 maps makes its f32 steps
  ill-conditioned (``PERF.md`` §6).
* ``cli.train`` with ``mesh: {spatial: 2}``, ``net: MobileNet`` at p 64:
  an epoch of one step with validation and evaluation against one
  process, by the Unetv2 run's rules.
* The strip ops in f64 against autograd through the whole tensor: the
  three max pools of the DeepLab trunks (3x3/2 pad 1, ResNet's stem;
  3x3/2 ceil mode, GoogLeNet's, on a map of odd width; 3x3/1 pad 1, the
  inceptions') on maps
  of negatives only, where a zero pad would win a window; the global
  mean of the ASPP's pooling and the squeeze-excitation; and a 3x3
  conv at dilation 12 on strips of 14 rows, which takes the halo, not
  the gather.
"""

import multiprocessing as mp
import shutil
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import _torch_ranks as ranks
from _bounded import kill_workers
from cvcs_tpu.models import build_model as jax_build_model
from cvcs_tpu.ops.losses import build_loss as jax_build_loss
from cvcs_tpu.train import build_optimizer as jax_build_optimizer
from cvcs_tpu.train.state import TrainState as JaxTrainState
from cvcs_tpu.train.step import make_train_step
from cvcs_tpu_torch.models.registry import MODEL_REGISTRY
from cvcs_tpu_torch.weights import jax_state_dict

NC, BATCH = ranks.NC, 4
KEY = jax.random.key(7)            # the JAX step's dropout key
ATOL = RTOL = 1e-4                 # JAX's spatial step's pin
LOSS_RTOL = 1e-5
WAIT_S = 600                       # each wait on a helper, as Ranks.join's
# case -> (net, patch, loss[, global batch]); "wCEL64" computes in f64 on
# both sides (parameters f32): at these inputs JAX's own f32 Resnet50 step
# moves the stem conv's update by 4.3e-4 from its f64 step's (6% of the
# largest update, 4x the tolerance), since the train-mode BatchNorm after
# the stem cancels the 0-255 pixels' mean out of the gradient, so f32
# cannot hold two f32 Resnet50 steps to 1e-4; "fused" (``build_fused_ce``)
# is held against the "unet64" JAX step, "mobilenet_fused" against JAX's
# wCEL step on its own batch of 2; "remat" (the encoder rematerialised:
# its blocks run again in the backward) against JAX's plain Unet step at
# p 80, whose 5-row strips at level 4 are gathered before the pool, so
# that level 5's blocks run whole
STEPS = {"unet64": ("Unet", 64, "wCEL"),
         "s2d64": ("Unetv2S2D", 64, "wCEL"),
         "swin64": ("SwinUnetTiny", 64, "wCEL"),
         "swin96": ("SwinUnetTiny", 96, "wCEL"),
         "segformer64": ("SegformerB0", 64, "wCEL"),
         "fused": ("Unet", 64, "fused"),
         "remat": ("Unet", 80, "remat"),
         "mobilenet64": ("MobileNet", 64, "wCEL", 2),
         "googlenet64": ("MobileNetGoogle", 64, "wCEL", 2),
         "resnet18_96": ("MobileNetResnet18", 96, "wCEL", 2),
         "resnet50_64": ("Resnet50", 64, "wCEL64", 2),
         "mobilenet_fused": ("MobileNet", 64, "fused", 2)}
# a case on another's inputs and reference
SHARED = {"fused": "unet64", "mobilenet_fused": "mobilenet64"}
DEEPLAB = ("Resnet50", "MobileNet", "MobileNetGoogle", "MobileNetResnet18")
WORLD2 = ("unet64", "s2d64", "swin64", "swin96", "segformer64",
          "mobilenet64", "googlenet64", "resnet18_96", "resnet50_64")
WORLD4 = ("swin64", "segformer64", "fused", "remat", "mobilenet_fused")


def _aspp(rows):
    return {f"conv (3, 3)/1 dilation {r} on {rows} rows" for r in (12, 24, 36)}



# the ops that took the gather, per case at spatial 2 (SegFormer's K/V
# gathers are its design: the reduced K/V tokens span the whole map)
GATHERS = {"unet64": set(), "s2d64": set(), "swin64": set(),
           "swin96": {"swin stage 4 downsample"},
           "segformer64": {f"segformer K/V (sr {sr}) of {rows} rows"
                           for sr, rows in ((8, 16), (4, 8), (2, 4), (1, 2))},
           "fused": set(), "remat": {"max pool after level 4"},
           # the ASPP's rates wider than 2-, 3- or 4-row strips, MobileNet's
           # dilated 5x5 (a halo of 4) on strips of 2, and the ResNet-18
           # trunk's last stage (3 rows)
           "mobilenet64": _aspp(4) | {"conv (5, 5)/1 dilation 2 on 4 rows"},
           "googlenet64": _aspp(4), "resnet18_96": _aspp(6) | {
               "resnet layer4"}, "resnet50_64": _aspp(8)}
GATHERS["mobilenet_fused"] = GATHERS["mobilenet64"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_variables(shapes, seed: int) -> dict:
    """JAX variables of the given shapes from numpy draws (kernels with
    std sqrt(1/fan_in), LayerNorm/BatchNorm scales near 1, BN running
    statistics off 0/1): nothing is compiled to initialise."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name, shape = path[-1].key, s.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return rng.normal(0, fan_in ** -0.5, shape).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, shape).astype(np.float32)
        return rng.normal(0, 0.1, shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _batch(p: int, seed: int, batch: int = BATCH):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (batch, p, p, 3), np.uint8)
    msk = rng.integers(0, NC, (batch, p, p)).astype(np.int32)
    # the top rows mostly background: rank 0's strip holds few labels
    top = rng.random((batch, p // 2, p)) < 0.9
    msk[:, :p // 2] = np.where(top, 0, msk[:, :p // 2])
    return img, msk


def _weights():
    w = np.random.default_rng(9).uniform(0.5, 2.0, NC).astype(np.float32)
    w[0] = 0.0
    return w


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _dropout_out(tree):
    """The output of the one ``Dropout_0`` among captured intermediates."""
    for k, v in tree.items():
        if k == "Dropout_0":
            return v["__call__"][0]
        if isinstance(v, dict):
            got = _dropout_out(v)
            if got is not None:
                return got
    return None


def _inputs(net: str, p: int, seed: int, tmp, batch: int = BATCH,
            f64: bool = False) -> dict:
    """One case's numpy variables (JAX layout), the port's start state
    dict (saved for the ranks), the batch and, for SegFormer and DeepLab,
    the head dropout's keep mask that JAX's step draws (its key is
    fold_in(KEY, step 0)); with ``f64`` the model computes in f64 (its
    parameters f32) and the mask is drawn as under x64."""
    with jax.enable_x64(f64):
        return _inputs_of(net, p, seed, tmp, batch, f64)


def _inputs_of(net, p, seed, tmp, batch, f64) -> dict:
    kw = {"fused_attn": False} if net.startswith("Swin") else {}
    model, _ = jax_build_model(net, NC, dtype=jnp.float64 if f64
                               else jnp.float32, **kw)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, p, p, 3)), train=False))
    variables = _numpy_variables(shapes, seed)
    img, msk = _batch(p, seed + 1, batch)
    with torch.device("meta"):          # the bridge reads only its layout
        port = MODEL_REGISTRY[net].build(NC, dtype=torch.float32)
    path = tmp / f"{net}_{p}_{batch}.pt"
    torch.save(jax_state_dict(port, variables), path)
    keep = None
    if net in DEEPLAB:
        # the ASPP dropout's mask, fed to both sides (:func:`_keeping`)
        rows = p // (8 if net.startswith("Resnet") else 16)
        keep = np.random.default_rng(seed + 2).random(
            (batch, rows, rows, 256)) < 0.5
    elif net.startswith("Segformer"):
        def dropped(v, x, k):
            _, mutated = model.apply(
                v, x, train=True, mutable=["batch_stats", "intermediates"],
                rngs={"dropout": k},
                capture_intermediates=lambda mdl, _: isinstance(
                    mdl, fnn.Dropout))
            return _dropout_out(mutated["intermediates"])

        keep = np.asarray(jax.jit(dropped)(
            variables, jnp.asarray(img, jnp.float32),
            jax.random.fold_in(KEY, 0))) != 0
    return dict(net=net, model=model, variables=variables, port=port,
                path=str(path), img=img, msk=msk, keep=keep,
                loss_kind="wCEL", f64=f64)


def _jax_step(case: dict):
    """The JAX package's single-device f32 step (Swin on its einsum path,
    the same function as the fused op at f32; f64 compute under x64 for
    an ``f64`` case): (loss, the port's state dict after it)."""
    with jax.enable_x64(case["f64"]):
        return _jax_step_of(case)


def _keeping(model, keep):
    """``model.apply`` whose ``Dropout`` keeps ``keep`` (the mask the
    port is given) instead of drawing a mask: one jitted trace a case,
    where capturing JAX's own draw would trace the forward again."""
    def drop(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            scale = jnp.asarray(1.0 - context.module.rate, x.dtype)
            return jnp.where(keep, x / scale, jnp.zeros((), x.dtype))
        return next_fun(*args, **kwargs)

    def apply(*args, **kwargs):
        with fnn.intercept_methods(drop):
            return model.apply(*args, **kwargs)

    return apply


def _jax_step_of(case: dict):
    model, variables = case["model"], case["variables"]
    apply_fn = (_keeping(model, case["keep"]) if case["net"] in DEEPLAB
                else model.apply)
    opt = jax_build_optimizer("SGD2")
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        # one compile for the whole state: eager init compiles a zeros_like
        # per leaf shape
        opt_state=jax.jit(opt.init)(params), apply_fn=apply_fn, tx=opt.tx)
    step = make_train_step(jax_build_loss("wCEL", weights=_weights(),
                                          ignore_background=True))
    new, loss = step(state, jnp.asarray(case["img"]),
                     jnp.asarray(case["msk"]), jnp.zeros((), jnp.uint8),
                     jnp.float32(opt.lr_for_epoch(0)), KEY)
    after = jax_state_dict(case["port"], _host(
        {"params": new.params, "batch_stats": new.batch_stats}))
    return float(loss), {k: v.numpy() for k, v in after.items()
                         if not k.endswith("num_batches_tracked")}


def _steps(cases, names):
    return {n: (c["net"], c["path"], c["img"], c["msk"], c["loss_kind"],
                _weights(), c["keep"])
            for n, c in cases.items() if n in names}


def _cases(names, tmp) -> dict:
    """The inputs of the ``STEPS`` cases in ``names``, each seeded by its
    place in ``STEPS``."""
    cases = {}
    for seed, (name, (net, p, loss, *batch)) in enumerate(STEPS.items()):
        if name in names:
            cases[name] = (dict(cases[SHARED[name]], loss_kind=loss)
                           if name in SHARED else
                           dict(_inputs(net, p, 10 * seed, tmp, *batch,
                                        f64=loss == "wCEL64"),
                                loss_kind=loss))
    return cases


def _refs(cases) -> dict:
    refs = {n: _jax_step(c) for n, c in cases.items() if n not in SHARED}
    refs.update({n: refs[s] for n, s in SHARED.items() if n in cases})
    return refs


# the cases whose inputs and JAX steps a helper process computes while
# this one computes the others' (tracing the four DeepLab steps is the
# longest part of this file)
HELPED = ("mobilenet64", "googlenet64", "resnet18_96", "resnet50_64",
          "mobilenet_fused")
_HELPED_CASES: dict = {}            # in the helper process


def _helper_inputs(tmp):
    import conftest  # noqa: F401  the JAX platform and compile cache

    _HELPED_CASES.update(_cases(HELPED, tmp))
    return _steps(_HELPED_CASES, HELPED)


def _helper_refs():
    return _refs(_HELPED_CASES)


def _one_process(cli, epoch) -> dict:
    """The one-process ``cli.train`` references, on one thread as each
    rank runs."""
    torch.set_num_threads(1)
    return dict(single=ranks.train_cli_run(cli),
                single_epoch=ranks.train_cli_epoch(epoch))


# -- the halo ----------------------------------------------------------------
HALO_SHAPE = (2, 8, 3, 2)           # (B, rows, W, C), rows over 2 ranks
# name -> (tops, bots, ring): counts per rank
HALOS = {"conv": ((1, 1), (1, 1), False),
         "uneven": ((2, 0), (3, 1), False),
         "ring": ((3, 1), (2, 4), True)}


def _halo_cases():
    rng = np.random.default_rng(11)
    whole = rng.standard_normal(HALO_SHAPE)
    n, h = 2, HALO_SHAPE[1] // 2
    cases = {}
    for name, (tops, bots, ring) in HALOS.items():
        grads = [rng.standard_normal((2, tops[r] + h + bots[r], 3, 2))
                 for r in range(n)]
        cases[name] = (whole, grads, tops, bots, ring)
    cases["gather"] = (whole, [rng.standard_normal(HALO_SHAPE)
                               for _ in range(n)], 0, 0, False)
    return cases


def _halo_rows(rank, h, rows, top, bot, ring):
    """Row indices of rank's extended strip in the whole map; -1 = zero."""
    idx = []
    for i in range(rank * h - top, (rank + 1) * h + bot):
        idx.append(i % rows if ring else (i if 0 <= i < rows else -1))
    return idx


def _halo_reference(cases):
    """Per case and rank: (extended strip, gradient of the strip) by
    autograd through slices of the whole tensor."""
    want = {}
    for name, (whole, grads, tops, bots, ring) in cases.items():
        x = torch.from_numpy(whole).requires_grad_(True)
        rows, n = whole.shape[1], 2
        h = rows // n
        outs, total = [], 0.0
        for r in range(n):
            if name == "gather":
                y = x
            else:
                idx = _halo_rows(r, h, rows, tops[r], bots[r], ring)
                pad = torch.cat([x, x.new_zeros(x[:, :1].shape)], dim=1)
                y = pad[:, [i if i >= 0 else rows for i in idx]]
            outs.append(y.detach().numpy())
            total = total + (y * torch.from_numpy(grads[r])).sum()
        total.backward()
        want[name] = [(outs[r], x.grad.numpy()[:, r * h:(r + 1) * h])
                      for r in range(n)]
    return want


# -- cli.train ---------------------------------------------------------------
def _train_cfg(root, ck):
    return dict(train=str(root), validation=str(root),
                checkpoint_directory=str(ck), net="Unetv2", epochs=1,
                chunk_size=4, validation_chunk_size=4, patch_size=64,
                batch_size=8, loss="wCEL", opt="SGD2", ignore_background=True,
                random_shift=True, precision_evaluation_freq=1,
                num_classes=15, precision="f32", seed=3, device="cpu")


@pytest.fixture(scope="module")
def runs(gid15_root, tmp_path_factory):
    """Both launches; the JAX references are computed while they run,
    the ``HELPED`` cases' (and their inputs) in a helper process beside
    this one, and the one-process ``cli.train`` references in another
    from the start. The temporary
    directory (start weights, full-width checkpoints: about 1.5 GB) goes
    when the module's tests are done."""
    tmp = tmp_path_factory.mktemp("spatial")
    spawn = mp.get_context("spawn")
    helper = ProcessPoolExecutor(1, mp_context=spawn)
    single = ProcessPoolExecutor(1, mp_context=spawn)
    try:
        helped = helper.submit(_helper_inputs, tmp)
        helped_refs = helper.submit(_helper_refs)
        epoch = dict(_train_cfg(gid15_root, tmp / "mobilenet"),
                     net="MobileNet")
        one = single.submit(_one_process,
                            _train_cfg(gid15_root, tmp / "single"),
                            dict(epoch, checkpoint_directory=str(
                                tmp / "mobilenet_single")))
        cases = _cases(set(STEPS) - set(HELPED), tmp)
        steps = _steps(cases, STEPS) | helped.result(WAIT_S)
        launches = [
            ranks.start(ranks.spatial_body, 2, tmp, 1,
                        {n: steps[n] for n in WORLD2}, _halo_cases(),
                        _train_cfg(gid15_root, tmp / "mesh"), _op_cases(),
                        epoch),
            ranks.start(ranks.spatial_body, 4, tmp, 2,
                        {n: steps[n] for n in WORLD4}, None, None)]
        try:
            refs = _refs(cases) | helped_refs.result(WAIT_S)
            got2, got4 = [r.join() for r in launches]
        finally:
            for r in launches:
                r.kill()
        one = one.result(WAIT_S)
    except BaseException:
        for pool in (helper, single):     # shutdown would wait on them
            kill_workers(pool)
        raise
    finally:
        for pool in (helper, single):
            pool.shutdown(cancel_futures=True)
    yield dict(w2=got2, w4=got4, refs=refs, tmp=tmp, **one)
    shutil.rmtree(tmp, ignore_errors=True)


def _check_step(results, name, ref):
    loss, state, digest, gathered = results[0][name]
    for other in results[1:]:
        assert other[name][0] == loss and other[name][2] == digest, name
    want_loss, after = ref
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL, err_msg=name)
    assert set(state) == set(after)
    for k, want in after.items():
        np.testing.assert_allclose(state[k], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name}: {k}")
    assert set(gathered) == GATHERS[name], (name, gathered)


@pytest.mark.parametrize("name", WORLD2)
def test_spatial_step_equals_jax_single_device_step(runs, name):
    _check_step(runs["w2"], name, runs["refs"][name])


@pytest.mark.parametrize("name", WORLD4)
def test_data_by_spatial_step_equals_jax_single_device_step(runs, name):
    _check_step(runs["w4"], name, runs["refs"][name])


@pytest.mark.parametrize("name", list(HALOS) + ["gather"])
def test_halo_and_gather_gradients_equal_autograd_through_slices(runs, name):
    want = _halo_reference(_halo_cases())[name]
    for r in range(2):
        ext, grad = runs["w2"][r]["halo"][name]
        np.testing.assert_allclose(ext, want[r][0], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} rank {r} values")
        np.testing.assert_allclose(grad, want[r][1], rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} rank {r} gradient")


def test_ring_halo_wraps_the_last_rank_to_rank_0(runs):
    """The shifted windows' ring: rank 0's top halo is the last rank's
    bottom rows and the last rank's bottom halo rank 0's top rows, not
    zeros (a zero halo here would shift Swin's windows over padding)."""
    whole = _halo_cases()["ring"][0]
    (top0, bot1), rows = (HALOS["ring"][0][0], HALOS["ring"][1][1]), 8
    ext0, _ = runs["w2"][0]["halo"]["ring"]
    ext1, _ = runs["w2"][1]["halo"]["ring"]
    np.testing.assert_array_equal(ext0[:, :top0], whole[:, rows - top0:])
    np.testing.assert_array_equal(ext1[:, -bot1:], whole[:, :bot1])
    assert np.abs(ext0[:, :top0]).min() > 0
    assert np.abs(ext1[:, -bot1:]).min() > 0


def test_inference_halo_wider_than_a_strip_takes_the_gather(runs):
    """``exchange_row_halo`` with 6 rows over strips of 4 (it raised
    before): each rank's strip between the whole map's rows around it,
    zeros past the ends."""
    whole = _halo_cases()["conv"][0][0]             # (8, 3, 2)
    padded = np.concatenate([np.zeros((6, 3, 2)), whole, np.zeros((6, 3, 2))])
    for r in range(2):
        np.testing.assert_array_equal(runs["w2"][r]["wide"],
                                      padded[4 * r:4 * r + 16])


def _scaled_close(got, want, what):
    want = np.asarray(want, np.float64)
    tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol,
                               rtol=0, err_msg=what)


def test_train_cli_on_a_spatial_mesh_equals_one_process(runs):
    got, want, tmp = runs["w2"], runs["single"], runs["tmp"]
    a, b = got[0]["cli"], got[1]["cli"]
    assert a["train"] == b["train"] and a["digest"] == b["digest"]
    assert a["confusion"] == b["confusion"]
    assert len(want["train"]) == 1 and len(want["resumed_train"]) == 2
    assert a["resumed_from"] == want["resumed_from"] == 1
    for key in ("train", "val", "resumed_train"):
        _scaled_close(a[key], want[key], key)
    # the evaluation's confusion matrix: every pixel counted once; labels
    # may differ only at near-tie logits of the random weights
    mine, ref = np.asarray(a["confusion"]), np.asarray(want["confusion"])
    assert mine.sum() == ref.sum() > 0
    assert np.abs(mine - ref).sum() / 2 <= 1e-3 * ref.sum()
    for n in (1, 2):
        mine = torch.load(tmp / "mesh" / f"checkpoint{n}" / "state.pt",
                          weights_only=True)
        ref = torch.load(tmp / "single" / f"checkpoint{n}" / "state.pt",
                         weights_only=True)
        assert mine["step"] == ref["step"] == n
        for k, v in ref["model"].items():
            np.testing.assert_allclose(mine["model"][k], v, atol=ATOL,
                                       rtol=RTOL, err_msg=f"checkpoint{n} {k}")


def test_deeplab_train_cli_on_a_spatial_mesh_equals_one_process(runs):
    """``cli.train`` of MobileNet at spatial 2, an epoch of one step with
    validation and evaluation, against one process."""
    a, b = runs["w2"][0]["epoch"], runs["w2"][1]["epoch"]
    want, tmp = runs["single_epoch"], runs["tmp"]
    assert a == b
    assert len(want["train"]) == len(a["train"]) == 1
    for key in ("train", "val"):
        _scaled_close(a[key], want[key], key)
    mine, ref = np.asarray(a["confusion"]), np.asarray(want["confusion"])
    assert mine.sum() == ref.sum() > 0
    assert np.abs(mine - ref).sum() / 2 <= 1e-3 * ref.sum()
    mine = torch.load(tmp / "mobilenet" / "checkpoint1" / "state.pt",
                      weights_only=True)
    ref = torch.load(tmp / "mobilenet_single" / "checkpoint1" / "state.pt",
                     weights_only=True)
    assert mine["step"] == ref["step"] == 1
    for k, v in ref["model"].items():
        np.testing.assert_allclose(mine["model"][k], v, atol=ATOL,
                                   rtol=RTOL, err_msg=f"checkpoint1 {k}")


# -- the strip ops of the DeepLab trunks, in f64 --------------------------
# name -> (op, whole map shape (B, rows over 2 ranks, W, C), kwargs)
OPS = {"pool_3s2p1": ("max_pool", (2, 12, 7, 3),
                      dict(k=3, stride=2, padding=1)),
       "pool_ceil_odd_width": ("max_pool", (2, 12, 9, 3),
                               dict(k=3, stride=2, ceil_mode=True)),
       "pool_3s1p1": ("max_pool", (2, 12, 7, 3),
                      dict(k=3, stride=1, padding=1)),
       "mean": ("mean", (2, 12, 7, 3), {}),
       "conv_rate12": ("conv", (1, 28, 20, 4),
                       dict(cin=4, cout=3, rate=12, seed=5))}


def _op_cases():
    rng = np.random.default_rng(13)
    cases = {}
    for name, (op, shape, kw) in OPS.items():
        whole = rng.standard_normal(shape)
        if op == "max_pool":
            whole = -np.abs(whole) - 0.5    # negatives: a zero pad would win
        out = _op_reference(op, torch.from_numpy(whole), kw)
        h = out.shape[1] // 2
        grads = [rng.standard_normal(out.shape if op == "mean" else
                                     (shape[0], h) + out.shape[2:])
                 for _ in range(2)]
        cases[name] = (op, whole, grads, kw)
    return cases


def _op_reference(op, x, kw):
    if op == "max_pool":
        return torch.nn.functional.max_pool2d(
            x.permute(0, 3, 1, 2), kw["k"], kw["stride"],
            kw.get("padding", 0), ceil_mode=kw.get("ceil_mode", False)
        ).permute(0, 2, 3, 1)
    if op == "mean":
        return x.mean((1, 2), keepdim=True)
    conv = ranks.strip_conv(**kw)
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


@pytest.mark.parametrize("name", list(OPS))
def test_strip_ops_equal_autograd_through_the_whole_map(runs, name):
    """Each rank's rows of the op and the gradient that comes back to its
    strip equal autograd through the whole map of the summed per-rank
    objectives; none takes the gather (the dilation-12 conv's halo of 12
    rows fits in strips of 14)."""
    op, whole, grads, kw = _op_cases()[name]
    x = torch.from_numpy(whole).requires_grad_(True)
    y = _op_reference(op, x, kw)
    h = y.shape[1] // 2
    parts = [y if op == "mean" else y[:, r * h:(r + 1) * h] for r in range(2)]
    sum((part * torch.from_numpy(g)).sum()
        for part, g in zip(parts, grads)).backward()
    rows = whole.shape[1] // 2
    for r in range(2):
        got, grad, gathered = runs["w2"][r]["ops"][name]
        np.testing.assert_allclose(got, parts[r].detach().numpy(),
                                   rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} rank {r} values")
        np.testing.assert_allclose(
            grad, x.grad.numpy()[:, r * rows:(r + 1) * rows], rtol=1e-12,
            atol=1e-12, err_msg=f"{name} rank {r} gradient")
        assert not gathered, gathered
