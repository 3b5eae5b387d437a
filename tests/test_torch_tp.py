"""Tensor parallelism of the port (``parallel/tp.py``) on two gloo ranks,
against the JAX package's replicated forward.

One launch at world 2 (data 1 x spatial 2, the TP axis ``spatial`` as
in JAX): full-width Unet at p 32, Resnet101 and SegformerMod at p 64,
f32, eval mode, from the same numpy variables as the JAX model, under
``shard_params`` and ``tensor_parallel`` with ``min_channels`` 512.

* The logits equal the port's replicated forward within atol and rtol
  1e-4 (``tests/test_tp.py``'s tolerance for JAX's TP forward against
  its replicated one), and the JAX package's replicated forward within
  1e-4 x max(1, |JAX|max), on both ranks. Against JAX the elementwise
  rule cannot hold at these scales: Resnet101's logits reach about 100,
  and the port's replicated forward differs from JAX's by up to 1.9e-4
  on 17 of its 131,072 logits near zero (f32 summation order), exactly as
  the TP forward does; the scaled rule is the port's standing one for
  full-width forwards against JAX (``tests/test_torch_deeplab.py``).
* Every kernel ``channel_shardings`` shards (JAX's rule: at least 512
  output channels) holds half its bytes on each rank, and there are
  many of them (the deep half of the U-Net, ResNet's stages 2-4,
  SegFormer's stages 2-4 and head).
* Each sharded conv or linear writes half its output channels, and
  every other one all of them: a ``TorchFunctionMode`` records the width
  each ``F.conv2d`` / ``F.linear`` / ``F.conv_transpose2d`` call writes.
  Resnet101's stage 4 writes none of its holders' full widths (512 and
  2048), as ``test_tp_resnet101_hlo_is_sharded_compute`` asks of JAX's
  HLO at eight devices; at two ranks its widths are 256 and 1024.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from cvcs_tpu.models import build_model as jax_build_model
from cvcs_tpu_torch.models.registry import MODEL_REGISTRY
from cvcs_tpu_torch.weights import jax_state_dict

NC, MIN_CHANNELS = ranks.NC, 512
CASES = {"unet": ("Unet", 32), "resnet101": ("Resnet101", 64),
         "segformer": ("SegformerMod", 64)}


def _numpy_variables(shapes, seed: int) -> dict:
    """JAX variables from numpy draws (kernels with std sqrt(1/fan_in),
    BN running statistics off 0/1); nothing is compiled to initialise."""
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


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks start first; JAX's replicated forwards run meanwhile.
    The state dicts (about 560 MB) go when the module's tests are done."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_cases, args = {}, {}
    for seed, (name, (net, p)) in enumerate(CASES.items()):
        model, _ = jax_build_model(net, NC, dtype=jnp.float32)
        shapes = jax.eval_shape(lambda: model.init(
            {"params": jax.random.key(0)}, jnp.zeros((1, p, p, 3)),
            train=False))
        variables = _numpy_variables(shapes, seed)
        x = np.random.default_rng(seed + 10).uniform(
            0, 255, (2, p, p, 3)).astype(np.float32)
        path = tmp / f"{name}.pt"
        torch.save(jax_state_dict(MODEL_REGISTRY[net].build(NC), variables),
                   path)
        jax_cases[name] = (model, variables, x)
        args[name] = (net, str(path), x)
    launch = ranks.start(ranks.tp_body, 2, tmp, args, MIN_CHANNELS)
    try:
        want = {name: np.asarray(jax.jit(
            lambda v, a, m=model: m.apply(v, a, train=False))(variables, x))
            for name, (model, variables, x) in jax_cases.items()}
        got = launch.join()
    finally:
        launch.kill()
    yield got, want
    shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_forward_equals_replicated_forwards(run, name):
    got, want = run
    base = got[0][name][3]
    scale = max(1.0, float(np.abs(want[name]).max()))
    np.testing.assert_allclose(base, want[name], atol=1e-4 * scale, rtol=0,
                               err_msg=f"{name} replicated vs JAX")
    for rank in range(2):
        np.testing.assert_allclose(got[rank][name][0], base, atol=1e-4,
                                   rtol=1e-4, err_msg=f"{name} rank {rank}")
        np.testing.assert_allclose(got[rank][name][0], want[name],
                                   atol=1e-4 * scale, rtol=0,
                                   err_msg=f"{name} rank {rank} vs JAX")


@pytest.mark.parametrize("name", list(CASES))
def test_tp_sharded_kernels_hold_half_their_bytes(run, name):
    got, _ = run
    for rank in range(2):
        sharded = got[rank][name][1]
        assert len(sharded) >= 7, sharded     # the U-Net has 7
        for k, (whole, mine) in sharded.items():
            assert 2 * mine == whole, (name, k, whole, mine)


@pytest.mark.parametrize("name", list(CASES))
def test_tp_sharded_holders_write_half_their_channels(run, name):
    got, _ = run
    for rank in range(2):
        sharded = {k.rsplit(".", 1)[0] for k in got[rank][name][1]}
        writes = got[rank][name][2]
        assert sharded <= set(writes), sharded - set(writes)
        for holder, (full, widths) in writes.items():
            want = full // 2 if holder in sharded else full
            assert widths == [want], (name, holder, full, widths)


@pytest.fixture
def stage4(run):
    return {h: w for h, w in run[0][0]["resnet101"][2].items()
            if h.startswith("backbone.layer4.")}


def test_tp_resnet101_stage4_writes_no_full_width(stage4):
    assert len(stage4) == 3 * 3 + 1          # three blocks, one projection
    widths = {c for _, ws in stage4.values() for c in ws}
    assert widths == {256, 1024}, widths
    assert not widths & {512, 2048}
