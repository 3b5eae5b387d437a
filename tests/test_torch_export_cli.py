"""The port's export entry point (``cvcs_tpu_torch.cli.export``) against
the JAX package's exporters (``cvcs_tpu.cli.export._EXPORTERS``, i.e.
``cvcs_tpu.utils.torch_export.export_*``), on the CPU.

* Unetv2, MobileNet and SwinUnetTiny: JAX variables of numpy draws
  (``jax.eval_shape``, nothing compiled), written as the ``.npz`` the
  port restores; the port's ``.pt`` holds exactly the JAX export's keys,
  each array equal bit for bit, with the same dtype (f32, and int64 for
  ``num_batches_tracked``), and loads with ``strict=True`` into a fresh
  port model.
* The exportable names are JAX's; another net raises in both; ``main``
  runs a YAML config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cvcs_tpu.cli.export import _EXPORTERS
from cvcs_tpu.models.registry import build_model as jax_build_model
from cvcs_tpu_torch.cli import export as texport
from cvcs_tpu_torch.models import build_model
from cvcs_tpu_torch.weights import flatten_variables
from test_torch_segformer import _numpy_variables

C = 16


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _npz(name: str, path) -> dict:
    model, _ = jax_build_model(name, C, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 32, 32, 3)),
        train=False))
    variables = _numpy_variables(shapes, seed=3)
    np.savez(path, **flatten_variables(variables))
    return variables


@pytest.mark.parametrize("name", ["Unetv2", "MobileNet", "SwinUnetTiny"])
def test_export_equals_jax_export(name, tmp_path):
    variables = _npz(name, tmp_path / "v.npz")
    want = _EXPORTERS[name](variables)
    out = texport.export(dict(net=name, load_checkpoint=str(tmp_path / "v.npz"),
                              output=str(tmp_path / "out.pt"), device="cpu",
                              patch_size=32))
    got = torch.load(out, weights_only=True)
    assert set(got) == set(want)
    for k, a in want.items():
        t = got[k]
        assert t.dtype == torch.from_numpy(np.asarray(a)).dtype, k
        np.testing.assert_array_equal(t.numpy(), a, err_msg=k)
    fresh, _ = build_model(name, C, device="cpu")
    fresh.load_state_dict(got, strict=True)
    for f in tmp_path.iterdir():       # Unetv2's two files take 240 MB
        f.unlink()


def test_exportable_names_and_refusal(tmp_path):
    assert set(texport.EXPORTABLE) == set(_EXPORTERS)
    with pytest.raises(ValueError, match="no torch exporter"):
        texport.export(dict(net="SegformerB0", load_checkpoint="x",
                            output=str(tmp_path / "o.pt"), device="cpu"))


def test_main_runs_a_config(tmp_path):
    _npz("SwinUnetTiny", tmp_path / "v.npz")
    path = tmp_path / "export.yaml"
    path.write_text(yaml.safe_dump(dict(
        net="SwinUnetTiny", load_checkpoint=str(tmp_path / "v.npz"),
        output=str(tmp_path / "swin.pt"), device="cpu")))
    assert texport.main(["export", str(path)]) == 0
    assert (tmp_path / "swin.pt").stat().st_size > 0
