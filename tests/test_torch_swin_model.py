"""Port SwinUNet vs the JAX SwinUNet on carried weights.

JAX variables are initialised once, the BN running stats are perturbed
away from 0/1 (so the carry of ``batch_stats`` is really tested), and
the same tree goes to the JAX model (``fused_attn=True``: the Pallas
kernel in interpret mode) and, through ``cvcs_tpu_torch.weights``, to
the port. Inputs are numpy draws fed to both.

Tolerances: f32 logits atol = 1e-4 * max(1, |ref|max) (every op in f32
on both sides; only summation orders differ); bf16 leg 5e-2 * scale, as
the JAX package's own fused-vs-einsum model test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvcs_tpu.models.swin import SwinUNet as JaxSwinUNet
from cvcs_tpu.utils.torch_export import export_swin
from cvcs_tpu_torch.models.swin import SwinUNet
from cvcs_tpu_torch.weights import (flatten_variables, swin_state_dict,
                                    unflatten_npz)

TINY = dict(dims=(8, 16, 32, 64), depths=(1, 1, 2, 1), heads=(1, 2, 4, 8),
            window=4)
NUM_CLASSES = 5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several pytest workers on one
    machine, and torch's default of a thread per core oversubscribes it
    (observed: the train CLI test took 375 s under six workers, 10 s
    alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_variables(bands: int, seed: int = 0) -> dict:
    """JAX SwinUNet variables with BN running stats moved off 0/1."""
    model = JaxSwinUNet(num_classes=NUM_CLASSES, dtype=jnp.float32, **TINY)
    x = jnp.zeros((1, 32, 32, bands), jnp.float32)
    variables = jax.jit(model.init, static_argnames=("train",))(
        {"params": jax.random.key(seed)}, x, train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed + 100)
    for dec in variables["batch_stats"].values():
        for bn in dec.values():
            bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return variables


def port_model(variables: dict, bands: int, dtype=torch.float32) -> SwinUNet:
    model = SwinUNet(NUM_CLASSES, in_channels=bands, dtype=dtype, **TINY)
    model.load_state_dict(swin_state_dict(variables, TINY["depths"]),
                          strict=True)
    return model.eval()


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def test_weight_carry_equals_export_swin():
    variables = jax_variables(bands=3)
    sd = swin_state_dict(variables, TINY["depths"])
    ref = export_swin(variables, depths=TINY["depths"])
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    # the exporter's output loads into the port with strict=True
    model = SwinUNet(NUM_CLASSES, **TINY)
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v))
                           for k, v in ref.items()}, strict=True)
    # and the .npz layout round-trips the tree
    again = swin_state_dict(unflatten_npz(flatten_variables(variables)),
                            TINY["depths"])
    for k in sd:
        assert torch.equal(sd[k], again[k]), k


@pytest.mark.parametrize("px,bands,dtype", [
    (32, 3, "f32"), (64, 4, "f32"), (64, 3, "bf16"), (32, 4, "bf16")])
def test_swin_unet_logits_match_jax(px, bands, dtype):
    variables = jax_variables(bands)
    x = np.random.default_rng(px + bands).uniform(
        0, 255, (2, px, px, bands)).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jmodel = JaxSwinUNet(num_classes=NUM_CLASSES, fused_attn=True, dtype=jdt,
                         **TINY)
    want = np.asarray(jax.jit(
        lambda v, a: jmodel.apply(v, a, train=False))(variables, x))
    model = port_model(variables, bands,
                       torch.float32 if dtype == "f32" else torch.bfloat16)
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, px, px, NUM_CLASSES)
    scale = max(1.0, float(np.abs(want).max()))
    tol = 1e-4 if dtype == "f32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol * scale)
