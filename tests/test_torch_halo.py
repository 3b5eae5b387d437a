"""The port's halo exchange and row-sharded scene paths on 2 and 4 gloo
ranks, against the JAX package's under ``shard_map`` on as many of its 8
CPU devices.

* ``exchange_row_halo`` with ``axis=0`` (a row strip) and ``axis=1`` (a
  scene stack): [prev's bottom rows | strip | next's top rows], zeros at
  the mesh's ends, equal to JAX's on the same numpy strips.
* ``predict_scene_sharded`` at spatial 2 and 4 on a tile-aligned scene, a
  raster with bottom and right overhang (whose edge tiles' labels depend
  on it) and under ``bug_parity``, with the JAX tests' fake models (the
  label rides in the pixel: ``identity`` and the 3x3 ``blur``), and a tiny
  SwinUNet on weights carried from JAX (the bridge; f32, JAX's einsum
  attention, the port's plain one on the CPU); ``predict_scenes_sharded``
  at data 2 x spatial 2 on 4 ranks (each scene's halo stays in its own
  spatial group) and data 2 on 2; ``predict_scene_fullconv_sharded`` with
  and without ``col_tiles``. Every label map equals JAX's sharded
  function's and the port's single-device path's, bit for bit, on every
  rank.
* The geometry errors keep JAX's texts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import _torch_ranks as ranks
from cvcs_tpu.core.mesh import MeshConfig, create_mesh
from cvcs_tpu.infer import InferenceConfig as JaxInferenceConfig
from cvcs_tpu.infer import SceneSegmenter as JaxSceneSegmenter
from cvcs_tpu.models.swin import SwinUNet as JaxSwinUNet
from cvcs_tpu.parallel.halo import exchange_row_halo as jax_exchange
from cvcs_tpu_torch.core.mesh import DATA_AXIS, SPATIAL_AXIS, Mesh
from cvcs_tpu_torch.parallel.halo import sharded_rows
from test_inference import _scene, blur_apply, identity_apply
from test_torch_swin_model import NUM_CLASSES, TINY, jax_variables

P16, BC24 = 16, 24                       # the JAX engine tests' geometry
FAKE = dict(patch_size=P16, border_correction=BC24, batch_tiles=4,
            num_classes=ranks.NC)
SWIN = dict(patch_size=32, border_correction=64, batch_tiles=5,
            num_classes=NUM_CLASSES)
JAX_FAKE = {ranks.identity_model: identity_apply,
            ranks.blur_model: blur_apply}


def _jax_mesh(data, spatial):
    return create_mesh(MeshConfig(data=data, spatial=spatial),
                       devices=jax.devices()[:data * spatial])


def _cases(world: int, swin_vars) -> dict:
    """Halo strips and engine cases for ``world`` ranks (2 tile rows a
    rank for the fake models)."""
    rows = np.arange(world * 4 * 3, dtype=np.float32).reshape(world * 4, 3)
    stack = np.arange(2 * world * 4 * 3, dtype=np.float32).reshape(
        2, world * 4, 3)
    h = 2 * P16 * world
    aligned = _scene(h=h, w=64, seed=4)[0]
    overhang = _scene(h=h + 8, w=64 + 8, seed=30)[0]
    rng = np.random.default_rng(5)
    swin_scene = rng.integers(0, 256, (4 * 32 + 16, 3 * 32 + 16, 3),
                              dtype=np.uint8)
    engine = {
        "aligned": ("scene", ranks.identity_model, FAKE, "sp", aligned, {}),
        "overhang": ("scene", ranks.blur_model, FAKE, "sp", overhang, {}),
        "bug_parity": ("scene", ranks.identity_model,
                       dict(FAKE, bug_parity=True), "sp", aligned, {}),
        "swin": ("scene", swin_vars, SWIN, "sp", swin_scene, {}),
        "fullconv": ("fullconv", ranks.identity_model, FAKE, "sp",
                     _scene(h=h, w=96, seed=12)[0], {}),
        "fullconv_ct2": ("fullconv", ranks.blur_model, FAKE, "sp",
                         _scene(h=h, w=96, seed=13)[0], dict(col_tiles=2)),
        "fullconv_ct3": ("fullconv", ranks.identity_model, FAKE, "sp",
                         _scene(h=h, w=96, seed=12)[0], dict(col_tiles=3)),
    }
    engine["scenes"] = (
        "scenes", ranks.blur_model, FAKE, "scenes",
        [_scene(h=4 * P16 + 8, w=2 * P16 + 8, seed=40 + i)[0]
         for i in range(4)], {})
    return dict(halo={"rows": ([rows[r * 4:(r + 1) * 4]
                                for r in range(world)], 2, 0),
                      "stack": ([stack[:, r * 4:(r + 1) * 4]
                                 for r in range(world)], 1, 1)},
                engine=engine)


@pytest.fixture(scope="module")
def swin_vars():
    return jax_variables(bands=3, seed=1)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def run(request, tmp_path_factory, swin_vars):
    world = request.param
    cases = _cases(world, swin_vars)
    results = ranks.launch(ranks.halo_body, world,
                           tmp_path_factory.mktemp("halo"), cases)
    return world, cases, results


def _jax_halo(strips, halo, axis, world):
    x = jnp.asarray(np.concatenate(strips, axis=axis))
    spec = P(SPATIAL_AXIS, None) if axis == 0 else P(None, SPATIAL_AXIS,
                                                     None)
    fn = shard_map(lambda local: jax_exchange(local, halo, SPATIAL_AXIS,
                                              axis=axis),
                   mesh=_jax_mesh(1, world), in_specs=(spec,),
                   out_specs=spec, check_rep=False)
    return np.split(np.asarray(fn(x)), world, axis=axis)


def test_halo_matches_jax(run):
    world, cases, results = run
    for name, (strips, halo, axis) in cases["halo"].items():
        want = _jax_halo(strips, halo, axis, world)
        for r in range(world):
            got = results[r][name]
            np.testing.assert_array_equal(got, want[r], err_msg=f"{name} {r}")
        first = np.moveaxis(results[0][name], axis, 0)
        last = np.moveaxis(results[-1][name], axis, 0)
        assert not first[:halo].any() and not last[-halo:].any()
        inner = np.moveaxis(results[1][name], axis, 0)
        prev = np.moveaxis(strips[0], axis, 0)
        np.testing.assert_array_equal(inner[:halo], prev[-halo:])


def _jax_engine(kind, model, cfg, mesh_name, scene, kw, world):
    if isinstance(model, dict):
        jmodel = JaxSwinUNet(num_classes=NUM_CLASSES, dtype=jnp.float32,
                             fused_attn=False, **TINY)
        seg = JaxSceneSegmenter(jmodel.apply, model,
                                JaxInferenceConfig(**cfg))
    else:
        seg = JaxSceneSegmenter(JAX_FAKE[model], {}, JaxInferenceConfig(**cfg))
    jmesh = (_jax_mesh(2, world // 2) if mesh_name == "scenes"
             else _jax_mesh(1, world))
    fn = {"scene": seg.predict_scene_sharded,
          "scenes": seg.predict_scenes_sharded,
          "fullconv": seg.predict_scene_fullconv_sharded}[kind]
    return np.asarray(fn(scene, jmesh, **kw)).astype(np.uint8)


def _port_single(kind, model, cfg, scene, kw, world):
    seg = ranks.segmenter(model, **cfg)
    if kind == "scene":
        return seg.predict_scene(scene).numpy()
    if kind == "scenes":
        return np.stack([seg.predict_scene(s).numpy() for s in scene])
    padded, rows, cols, halo = seg.pad_scene_fullconv(scene)
    return seg.predict_padded_fullconv(padded, rows, cols, halo,
                                       band_rows=rows // world,
                                       **kw).numpy()


def _check_engine(run, names):
    world, cases, results = run
    for name in names:
        kind, model, cfg, mesh_name, scene, kw = cases["engine"][name]
        got = results[0][name]
        for r in range(1, world):
            assert results[r][name] == int(got.astype(np.int64).sum()), name
        want = _jax_engine(kind, model, cfg, mesh_name, scene, kw, world)
        assert len(np.unique(want)) > 1, name     # not a vacuous check
        np.testing.assert_array_equal(got, want, err_msg=f"{name} vs JAX")
        single = _port_single(kind, model, cfg, scene, kw, world)
        np.testing.assert_array_equal(got, single,
                                      err_msg=f"{name} vs one device")


def test_scene_sharded_matches_jax(run):
    _check_engine(run, ["aligned", "bug_parity"])


def test_scene_sharded_overhang_matches_jax(run):
    world, cases, _ = run
    _, _, cfg, _, scene, _ = cases["engine"]["overhang"]
    seg = ranks.segmenter(ranks.blur_model, **cfg)
    cropped = seg.predict_scene(scene[:scene.shape[0] - 8,
                                      :scene.shape[1] - 8]).numpy()
    single = seg.predict_scene(scene).numpy()
    assert not np.array_equal(single, cropped)   # the overhang matters
    _check_engine(run, ["overhang"])


def test_scene_sharded_swin_bridge_matches_jax(run):
    _check_engine(run, ["swin"])


def test_scenes_sharded_matches_jax(run):
    """Data 2 x spatial 1 on 2 ranks, data 2 x spatial 2 on 4."""
    _check_engine(run, ["scenes"])


def test_fullconv_sharded_matches_jax(run):
    _check_engine(run, ["fullconv", "fullconv_ct2", "fullconv_ct3"])


def test_geometry_errors_keep_jax_texts():
    """Raised before any collective, so a mesh without groups serves."""
    m = Mesh({DATA_AXIS: 1, SPATIAL_AXIS: 3}, 0, 0, 0, (0,), (0, 1, 2),
             None, None, torch.device("cpu"))
    seg = ranks.segmenter(ranks.identity_model, **FAKE)
    scene = _scene(h=64, w=96, seed=1)[0]      # 4 x 6 tiles
    with pytest.raises(ValueError, match="4 tile rows do not shard over 3 "
                                         "devices"):
        seg.predict_scene_sharded(scene, m)
    with pytest.raises(ValueError, match="4 tile rows do not shard over 3 "
                                         "devices"):
        seg.predict_scene_fullconv_sharded(scene, m)
    with pytest.raises(ValueError, match="spatial axis"):
        seg.predict_scenes_sharded([scene, scene], m)
    m2 = Mesh({DATA_AXIS: 1, SPATIAL_AXIS: 2}, 0, 0, 0, (0,), (0, 1),
              None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="col_tiles=4 must be a positive "
                                         "divisor"):
        seg.predict_scene_fullconv_sharded(scene, m2, col_tiles=4)
    with pytest.raises(ValueError, match="row_tiles=3 must divide the "
                                         "per-device 2 tile rows"):
        seg.predict_scene_fullconv_sharded(scene, m2, row_tiles=3)
    m3 = Mesh({DATA_AXIS: 3, SPATIAL_AXIS: 1}, 0, 0, 0, (0, 1, 2), (0,),
              None, None, torch.device("cpu"))
    with pytest.raises(ValueError, match="2 scenes do not shard over the "
                                         "data axis"):
        seg.predict_scenes_sharded([scene, scene], m3)
    assert sharded_rows(32, 8) == 4
    with pytest.raises(ValueError, match="do not shard evenly"):
        sharded_rows(30, 8)
