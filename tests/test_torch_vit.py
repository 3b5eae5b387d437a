"""The port's ViT (``cvcs_tpu_torch.models.vit``, DINO's trunks) against
the JAX package's (``cvcs_tpu.models.vit``), on the CPU.

* A small ViT (dim 32, depth 2, heads 4, patch 8, pos_grid 4) with JAX's
  initialised variables carried by ``weights.vit_state_dict``: the CLS
  embedding and the patch tokens on the trained grid (32 x 32) and off
  it (48 x 48 and 40 x 40: DINO's bicubic resize of the positional
  embeddings). f32 within 1e-5 * max(1, |ref|max), TF32 off; bf16 within
  5e-2 * max(1, |ref|max) (the frameworks round at other points).
* The bicubic matrices equal JAX's ``_torch_bicubic_matrix`` bit for
  bit, and their product equals ``F.interpolate(mode="bicubic")`` with
  DINO's ``scale_factor`` within 1e-5.
* ``vit_state_dict`` equals JAX ``export_vit`` key for key, value for
  value; a DINO-named state dict (the JAX tests' DINO twin), saved as a
  hub ``.pth`` under ``"state_dict"``, loads with ``strict=True`` through
  ``weights.load_dino`` and gives what JAX gives after ``import_vit``
  (f32, 1e-5 of scale).
* The four DINO variants have JAX's shapes and parameter counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cvcs_tpu.models import vit as jvit
from cvcs_tpu.utils.torch_export import export_vit
from cvcs_tpu.utils.torch_import import import_vit
from cvcs_tpu_torch.models import vit as tvit
from cvcs_tpu_torch.weights import load_dino, vit_state_dict
from test_torch_segformer import _close
from test_vit import _TorchDinoTwin

TOL = {"f32": 1e-5, "bf16": 5e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SMALL = dict(dim=32, depth=2, heads=4, patch=8, pos_grid=4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread, and f32 products in f32 (no TF32)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jvars():
    model = jvit.ViT(**SMALL, dtype=jnp.float32)
    v = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return jax.tree.map(np.asarray, v)


def _images(size: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (2, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("precision,size", [
    ("f32", 32), ("f32", 48), ("f32", 40), ("bf16", 32), ("bf16", 48)])
def test_forward_matches_jax(jvars, precision, size):
    jdt, tdt = DTYPES[precision]
    x = _images(size)
    jcls, jtok = jax.jit(jvit.ViT(**SMALL, dtype=jdt).apply)(
        jvars, jnp.asarray(x))
    model = tvit.ViT(**SMALL, dtype=tdt)
    model.load_state_dict(vit_state_dict(jvars, SMALL["depth"]), strict=True)
    with torch.no_grad():
        cls, tok = model(torch.from_numpy(x))
    assert cls.dtype == torch.float32 and tok.dtype == tdt
    assert tok.shape == (2, (size // 8) ** 2, 32)
    _close(cls, np.asarray(jcls), TOL[precision], "cls")
    _close(tok, np.asarray(jtok, np.float32), TOL[precision], "tokens")


@pytest.mark.parametrize("n_in,n_out", [(4, 6), (4, 5), (14, 28), (14, 9),
                                        (28, 13)])
def test_bicubic_matrix_equals_jax_and_torch(n_in, n_out):
    scale = n_in / (n_out + 0.1)                  # DINO's mapping
    got = tvit.torch_bicubic_matrix(n_in, n_out, scale)
    np.testing.assert_array_equal(
        got, jvit._torch_bicubic_matrix(n_in, n_out, scale=scale))
    np.testing.assert_array_equal(tvit.torch_bicubic_matrix(n_in, n_out),
                                  jvit._torch_bicubic_matrix(n_in, n_out))
    x = np.random.default_rng(n_out).standard_normal(
        (1, 3, n_in, n_in)).astype(np.float32)
    sf = (n_out + 0.1) / n_in
    want = F.interpolate(torch.from_numpy(x), scale_factor=(sf, sf),
                         mode="bicubic", align_corners=False).numpy()
    prod = np.einsum("oh,bchw->bcow", got, x)
    prod = np.einsum("ow,bchw->bcho", got, prod)
    np.testing.assert_allclose(prod, want, rtol=1e-5, atol=1e-5)


def test_vit_state_dict_equals_export_vit(jvars):
    want = export_vit(jvars, depth=SMALL["depth"])
    got = vit_state_dict(jvars, SMALL["depth"])
    assert list(got) == list(want)
    for k, a in want.items():
        np.testing.assert_array_equal(got[k].numpy(), a, err_msg=k)
    assert set(got) == set(tvit.ViT(**SMALL).state_dict())


def test_dino_checkpoint_loads_strict_and_matches_jax_import(tmp_path):
    torch.manual_seed(0)
    twin = _TorchDinoTwin(32, 2, 4, 8, 4).eval()
    path = tmp_path / "dino.pth"
    torch.save({"state_dict": twin.state_dict()}, path)
    model = load_dino(tvit.ViT(**SMALL, dtype=torch.float32), path).eval()
    jmodel = jvit.ViT(**SMALL, dtype=jnp.float32)
    variables = import_vit(twin.state_dict(), depth=SMALL["depth"])
    for size in (32, 48):
        x = _images(size, seed=size)
        jcls, _ = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            cls, _ = model(torch.from_numpy(x))
        _close(cls, np.asarray(jcls), TOL["f32"], f"cls at {size}")
    with torch.no_grad():                 # the twin: DINO's own forward
        ref = twin(torch.from_numpy(_images(32, seed=32)).permute(0, 3, 1, 2))
    _close(model(torch.from_numpy(_images(32, seed=32)))[0].detach(), ref,
           TOL["f32"], "twin")


@pytest.mark.parametrize("variant", sorted(tvit.VIT_VARIANTS))
def test_variants_match_jax(variant):
    jmodel = jvit.dino_vit(variant, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 224, 224, 3))))
    want = export_vit(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes), depth=jmodel.depth)
    model = tvit.ViT(**tvit.VIT_VARIANTS[variant])
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: a.shape for k, a in want.items()}
    assert model.patch == jmodel.patch and model.pos_grid == jmodel.pos_grid
    with pytest.raises(ValueError):
        tvit.dino_vit("vitc32")
