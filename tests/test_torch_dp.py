"""Data-parallel training of the port on 2 and 4 gloo ranks, against the
JAX package's data-parallel step (``make_train_step`` under a sharded
``jit`` on its CPU devices) and the port's single-process step.

* Full-width Unet (the BatchNorm-heavy net), f32, SGD2, one step from
  JAX-initialised weights carried by the bridge, on a global batch of 8
  patches at p 32, each rank taking its share:
  - CEL at accum 1, against the port's single-process step;
  - wCEL with ``ignore_background`` and ``grad_accum`` 2, its labels
    skewed so that the ranks' shares hold very different class mixes
    (samples 0, 1, 4 and 5 mostly background), against JAX's data-2 step
    and the port's single-process step: a per-rank loss normaliser, per-rank
    BatchNorm statistics or each rank taking its own k-th micro-batch
    instead of its slice of global micro-batch k would each miss;
  - the same through ``build_fused_ce`` (K3 and K4's plain versions on
    the CPU, their sums reduced over the data group).
  Tolerances are JAX's for its own data-parallel steps
  (``tests/test_multidevice_train.py``): the loss within 1e-5 relative;
  every parameter and BatchNorm running statistic within atol 1e-5 + rtol
  1e-5 for the plain step, and within JAX's tolerance for its
  accumulating step, atol 2e-5 + rtol 1e-4, for the accum-2 steps (the
  first BatchNorm's running variance, about 1e3 on uint8-scale inputs, is
  a difference of two large sums, 2.9e-5 relative apart from JAX's; the
  deepest encoder's weights normalise 2 x 2 maps of 4 samples, 1.9e-5
  apart from the port's own single-process step at 2 ranks). Every rank
  ends on the same state.
* Sync-BN: the running variance of a BatchNorm on each rank's rows of one
  global batch takes the unbiased correction with the global count
  (``tests/test_multidevice_train.py:286``), equal to the single-device
  one.
* ``cli.train`` with ``mesh: {data: 2}`` on the synthetic set (SwinUnetTiny
  at p 64, batch 4, wCEL with ``ignore_background``, ``augmentation:
  fused``, ``random_shift``, an evaluation each epoch; 2 steps an epoch),
  then a resume for a second epoch with ``load_checkpoint: auto``, then
  ``cli.evaluate`` with the mesh: the losses and rank 0's checkpoints
  equal the single-process run's within 1e-5 * max(1, |ref|max) per tensor
  (observed 1.8e-6), and the evaluation's metrics equal. At p 32 the
  deepest decoder BatchNorm normalises 4 values a channel, and summation
  order differences grow there to 1e-3 in the loss within 24 steps, in
  both directions; so the run is kept to a few steps at p 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_ranks as ranks
from cvcs_tpu.core.mesh import DATA_AXIS, MeshConfig, create_mesh, replicate
from cvcs_tpu.models import build_model as jax_build_model
from cvcs_tpu.models.blocks import TorchBatchNorm
from cvcs_tpu.ops.losses import build_loss as jax_build_loss
from cvcs_tpu.train import build_optimizer as jax_build_optimizer
from cvcs_tpu.train import create_train_state
from cvcs_tpu.train.step import make_train_step
from cvcs_tpu_torch.cli import evaluate as evaluate_cli
from cvcs_tpu_torch.cli import train as train_cli
from cvcs_tpu_torch.models.unet import UNet
from cvcs_tpu_torch.weights import jax_state_dict, load_jax_variables

PATCH, BATCH = 32, 8
ATOL = RTOL = 1e-5
JAX_TOL = dict(atol=2e-5, rtol=1e-4)   # JAX's DP accum step's pin


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (BATCH, PATCH, PATCH, 3), np.uint8)
    msk = rng.integers(0, 16, (BATCH, PATCH, PATCH)).astype(np.int32)
    skew = msk.copy()
    for i in (0, 1, 4, 5):           # mostly background, a little class 1
        skew[i] = np.where(rng.random((PATCH, PATCH)) < 0.9, 0, 1)
    weights = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    weights[0] = 0.0
    return img, msk, skew, weights


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


@pytest.fixture(scope="module")
def setup():
    """The JAX initial variables, the inputs, and JAX's data-2 step (wCEL
    with ignore_background, accum 2) as a port state dict."""
    img, msk, skew, weights = _inputs()
    model, _ = jax_build_model("Unet", 16, dtype=jnp.float32)
    state = create_train_state(model, jax_build_optimizer("SGD2"),
                               jnp.zeros((BATCH, PATCH, PATCH, 3), jnp.uint8))
    variables = _host({"params": state.params,
                       "batch_stats": state.batch_stats})
    mesh = create_mesh(MeshConfig(data=2), devices=jax.devices()[:2])
    step = make_train_step(jax_build_loss("wCEL", weights=weights,
                                          ignore_background=True), accum=2)
    new, loss = step(
        replicate(state, mesh),
        jax.device_put(img, NamedSharding(mesh, P(DATA_AXIS, None, None,
                                                  None))),
        jax.device_put(skew, NamedSharding(mesh, P(DATA_AXIS, None, None))),
        jnp.zeros((), jnp.uint8), jnp.float32(6e-3), jax.random.key(0))
    port = load_jax_variables(UNet(16, dtype=torch.float32).eval(),
                              variables)
    jax_after = {k: v.numpy() for k, v in jax_state_dict(port, _host(
        {"params": new.params, "batch_stats": new.batch_stats})).items()
        if not k.endswith("num_batches_tracked")}
    start = {k: v.clone() for k, v in port.state_dict().items()}
    return dict(start=start, model=port, img=img, msk=msk,
                skew=skew, weights=weights, jax=(float(loss), jax_after))


@pytest.fixture(scope="module")
def singles(setup):
    """The port's single-process steps."""
    s = setup
    return {"cel": ranks.dp_step(s["model"], s["start"], s["img"],
                                 s["msk"], "CEL", 1),
            "wcel": ranks.dp_step(s["model"], s["start"], s["img"],
                                  s["skew"], "wCEL", 2,
                                  weights=s["weights"])}


def _bn_case():
    x = np.random.default_rng(7).standard_normal((16, 4)).astype(np.float32)
    return x, 0.1


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def run(request, setup, tmp_path_factory):
    world, s = request.param, setup
    tmp = tmp_path_factory.mktemp("dp")
    torch.save(s["start"], tmp / "start.pt")
    steps = {"cel": (s["img"], s["msk"], "CEL", 1, None),
             "wcel": (s["img"], s["skew"], "wCEL", 2, s["weights"]),
             "fused": (s["img"], s["skew"], "fused", 2, s["weights"])}
    return world, ranks.launch(ranks.dp_body, world, tmp,
                               str(tmp / "start.pt"), steps, _bn_case())


def _close(got: dict, want: dict, what: str, atol=ATOL, rtol=RTOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {k}")


def _moved(after: dict, before: dict) -> bool:
    return any(not np.array_equal(after[k], before[k]) for k in before)


def test_ranks_end_on_one_state(run):
    world, results = run
    for name in results[0]:
        if name == "bn":
            continue
        for r in range(1, world):
            assert results[r][name][0] == results[0][name][0], name
            assert results[r][name][2] == results[0][name][2], name


def test_dp_cel_step_equals_single_process(run, singles):
    _, results = run
    loss, state, _ = results[0]["cel"]
    want_loss, want = singles["cel"]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    _close(state, want, "CEL step")


def test_dp_wcel_accum_step_equals_jax_and_single_process(run, setup,
                                                          singles):
    _, results = run
    loss, state, _ = results[0]["wcel"]
    jax_loss, jax_after = setup["jax"]
    np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
    _close(state, jax_after, "wCEL accum 2 vs JAX data 2", **JAX_TOL)
    want_loss, want = singles["wcel"]
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    _close(state, want, "wCEL accum 2 vs one process", **JAX_TOL)
    before = {k: v.numpy() for k, v in setup["start"].items() if k in want}
    assert _moved(state, before)


def test_dp_fused_ce_step_equals_jax(run, setup, singles):
    _, results = run
    loss, state, _ = results[0]["fused"]
    jax_loss, jax_after = setup["jax"]
    np.testing.assert_allclose(loss, jax_loss, rtol=RTOL)
    _close(state, jax_after, "fused CE vs JAX data 2", **JAX_TOL)
    _close(state, singles["wcel"][1], "fused CE vs one process", **JAX_TOL)


def test_sync_bn_running_var_counts_every_rank(run):
    """The JAX package's own pin: its sync-BN (``axis_name``) equals its
    single-device BatchNorm; the port's data-parallel one equals both."""
    from jax.experimental.shard_map import shard_map

    _, results = run
    x, _ = _bn_case()
    single = TorchBatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32)
    v = single.init(jax.random.key(0), x, use_running_average=False)
    _, mut = single.apply(v, x, use_running_average=False,
                          mutable=["batch_stats"])
    mesh = create_mesh(MeshConfig(data=4), devices=jax.devices()[:4])
    sync = TorchBatchNorm(momentum=0.9, epsilon=1e-5, dtype=jnp.float32,
                          axis_name=DATA_AXIS)
    sv = sync.init(jax.random.key(0), x[:4], use_running_average=False)
    got_sync = jax.jit(shard_map(
        lambda variables, xs: sync.apply(
            variables, xs, use_running_average=False,
            mutable=["batch_stats"])[1]["batch_stats"]["var"],
        mesh=mesh, in_specs=(P(), P(DATA_AXIS, None)), out_specs=P(),
        check_rep=False))(sv, x)
    want_var = np.asarray(mut["batch_stats"]["var"])
    np.testing.assert_allclose(np.asarray(got_sync), want_var, rtol=1e-5)
    for got in results:
        mean, var = got["bn"]
        np.testing.assert_allclose(mean, np.asarray(
            mut["batch_stats"]["mean"]), atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(var, want_var, rtol=1e-5)


# -- cli.train / cli.evaluate over a data mesh --------------------------------
def _train_cfg(root, ck):
    return dict(train=str(root), validation=str(root),
                checkpoint_directory=str(ck), net="SwinUnetTiny", epochs=1,
                chunk_size=2, validation_chunk_size=2, patch_size=64,
                batch_size=4, loss="wCEL", opt="SGD2", ignore_background=True,
                random_shift=True, augmentation="fused",
                precision_evaluation_freq=1, num_classes=15, precision="f32",
                seed=3, device="cpu")


def _eval_cfg(root, ck):
    return dict(dataset=str(root), net="SwinUnetTiny", patch_size=64,
                load_checkpoint=str(ck / "checkpoint2"), precision="f32",
                num_classes=15, ignore_background=True, device="cpu")


def _single_run(cfg, eval_cfg):
    first = train_cli.build_trainer(cfg)
    first.train()
    resumed = train_cli.build_trainer(dict(cfg, epochs=2,
                                           load_checkpoint="auto"))
    resumed.train()
    return dict(train=first.training_loss_values,
                val=first.validation_loss_values,
                resumed_from=resumed.last_epoch,
                resumed_train=resumed.training_loss_values,
                metrics=evaluate_cli.evaluate(eval_cfg))


def _scaled_close(got, want, what):
    want = np.asarray(want, np.float64)
    tol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol,
                               rtol=0, err_msg=what)


def test_train_and_evaluate_cli_on_a_data_mesh(gid15_root, tmp_path):
    mesh_ck, single_ck = tmp_path / "mesh", tmp_path / "single"
    got = ranks.launch(ranks.train_cli_body, 2, tmp_path,
                       _train_cfg(gid15_root, mesh_ck),
                       _eval_cfg(gid15_root, mesh_ck))
    want = _single_run(_train_cfg(gid15_root, single_ck),
                       _eval_cfg(gid15_root, single_ck))
    assert got[0]["train"] == got[1]["train"]
    assert len(want["train"]) == 2 and len(want["resumed_train"]) == 4
    assert got[0]["resumed_from"] == want["resumed_from"] == 1
    for key in ("train", "val", "resumed_train"):
        _scaled_close(got[0][key], want[key], key)
    assert got[0]["metrics"] == want["metrics"] == got[1]["metrics"]
    for n in (1, 2):
        a = torch.load(mesh_ck / f"checkpoint{n}" / "state.pt",
                       weights_only=True)
        b = torch.load(single_ck / f"checkpoint{n}" / "state.pt",
                       weights_only=True)
        assert a["step"] == b["step"] == 2 * n
        for k, v in b["model"].items():
            _scaled_close(a["model"][k], v, f"checkpoint{n} {k}")
