"""The port's mesh (``cvcs_tpu_torch/core/mesh.py``) and ``cli.predict``
with a ``mesh``, on 4 gloo ranks, against the JAX package's
``cvcs_tpu/core/mesh.py`` on 4 of its 8 CPU devices.

* ``MeshConfig.resolve`` gives JAX's layouts and JAX's error text; in one
  process a mesh over more ranks than exist raises it, and a 1 x 1 mesh is
  no mesh.
* On a 2 x 2 mesh: rank r holds JAX's device r's (data, spatial)
  coordinates (row-major), the data and spatial groups hold the ranks JAX's
  mesh puts on each axis, ``shard_batch`` gives each rank the rows that
  JAX's ``shard_batch`` places on its device (a leaf that does not divide
  kept whole), ``replicate`` broadcasts rank 0's weights, and
  ``mesh_from_config`` with ``data: null`` fills the data axis.
* ``cli.predict`` in the four mesh modes of
  ``tests/test_predict_sharded_cli.py``: rows over ``spatial: 4``; scene
  groups over ``data: 2, spatial: 2`` with a remainder scene run alone;
  ``net: Ensemble``; ``fullconv_bands`` with a mesh. Rank 0 writes every
  PNG, and each equals the single-process run's, bit for bit.
* ``cli.serve`` with ``mesh: {data: 2, spatial: 2}`` over three rasters (a
  same-shape pair, scene-parallel, and one alone): rank 0 lists, writes the
  masks and the journal, and they equal the single-process daemon's.
"""

import json

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import _torch_ranks as ranks
from cvcs_tpu.core.mesh import MeshConfig as JaxMeshConfig
from cvcs_tpu.core.mesh import create_mesh as jax_create_mesh
from cvcs_tpu.core.mesh import shard_batch as jax_shard_batch
from cvcs_tpu_torch.cli import common
from cvcs_tpu_torch.cli import predict as predict_cli
from cvcs_tpu_torch.core.mesh import (DATA_AXIS, SPATIAL_AXIS, MeshConfig,
                                      create_mesh, local_mesh)

P = 32


def _dataset(root, n, rows, cols, seed):
    """A GID15-layout set of n scenes of rows x cols tiles at p 32."""
    (root / "Image__8bit_NirRGB").mkdir(parents=True)
    (root / "Annotation__index").mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        img = rng.integers(0, 256, (rows * P, cols * P, 3), dtype=np.uint8)
        m = np.kron(rng.integers(0, 16, (rows * 2, cols * 2), dtype=np.uint8),
                    np.ones((16, 16), np.uint8))
        Image.fromarray(img).save(root / "Image__8bit_NirRGB" / f"s{i}.png")
        Image.fromarray(m).save(
            root / "Annotation__index" / f"s{i}_15label.png")
    return str(root)


def _configs(tmp):
    """(name, config) of the four modes; their outputs land under tmp /
    name / {mesh, single}."""
    tall = _dataset(tmp / "tall", 1, 4, 2, seed=0)
    multi = _dataset(tmp / "multi", 5, 2, 2, seed=3)
    members = tmp / "ensemble.yaml"
    members.write_text(yaml.safe_dump({"SwinUnetTiny": None,
                                       "SegformerB0": None}))
    base = dict(net="SwinUnetTiny", patch_size=P, border_correction=2 * P,
                num_classes=15, precision="f32", mask_only=True,
                device="cpu")
    return {
        "spatial": dict(base, dataset=tall, mesh={"data": 1, "spatial": 4}),
        "scenes": dict(base, dataset=multi,
                       mesh={"data": 2, "spatial": 2}),
        "ensemble": dict(base, dataset=tall, net="Ensemble",
                         ensemble_config=str(members),
                         mesh={"spatial": 4}),
        "fullconv": dict(base, dataset=tall, fullconv_bands=1,
                         mesh={"spatial": 4}),
    }


def _outputs(cfg, tmp, which):
    out = tmp / which
    return dict(cfg, output=str(out / "patches"),
                out_image=str(out / "map.png"))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    configs = _configs(tmp)
    batch = dict(image=np.arange(8 * 2 * 2 * 3, dtype=np.uint8).reshape(
        8, 2, 2, 3), odd=np.arange(6, dtype=np.float32).reshape(3, 2))
    mesh_cfgs = [_outputs(cfg, tmp / name, "mesh")
                 for name, cfg in configs.items()]
    watch = _watch_dir(tmp / "watch")
    results = ranks.launch(ranks.mesh_body, 4, tmp, batch, mesh_cfgs,
                           _serve_cfg(watch, tmp / "served_mesh",
                                      mesh={"data": 2, "spatial": 2}))
    return tmp, configs, batch, results


def _watch_dir(watch):
    watch.mkdir()
    rng = np.random.default_rng(9)
    for name, (h, w) in (("a.png", (128, 96)), ("b.png", (128, 96)),
                         ("c.png", (64, 160))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                        ).save(watch / name)
    return watch


def _serve_cfg(watch, out, **kw):
    return dict(watch_dir=str(watch), output=str(out), net="SwinUnetTiny",
                patch_size=P, border_correction=2 * P, precision="f32",
                device="cpu", max_polls=1, poll_s=0, **kw)


def _jax_mesh():
    return jax_create_mesh(JaxMeshConfig(data=2, spatial=2),
                           devices=jax.devices()[:4])


@pytest.mark.parametrize("data,spatial,n", [
    (None, 1, 4), (None, 2, 4), (2, 2, 4), (1, 4, 4), (None, 4, 8),
    (3, 1, 4), (None, 3, 4), (2, 1, 1)])
def test_resolve_matches_jax(data, spatial, n):
    try:
        want = JaxMeshConfig(data=data, spatial=spatial).resolve(n)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)):
            MeshConfig(data=data, spatial=spatial).resolve(n)
    else:
        assert MeshConfig(data=data, spatial=spatial).resolve(n) == want


def test_one_process():
    """No group and no launcher's environment: a world of one."""
    with pytest.raises(ValueError, match="mesh 2x1 does not cover 1 "
                                         "devices"):
        common.mesh_from_config({"mesh": {"data": 2}}, "cpu")
    assert common.mesh_from_config({"mesh": {"data": 1}}, "cpu") is None
    assert common.mesh_from_config({}, "cpu") is None
    m = create_mesh(MeshConfig(), device="cpu")
    assert m.shape == {DATA_AXIS: 1, SPATIAL_AXIS: 1} and m.size == 1
    assert m.data_group is None and m.spatial_group is None
    assert local_mesh("cpu").device == torch.device("cpu")


def test_layout_matches_jax(run):
    _, _, _, results = run
    jmesh = _jax_mesh()
    devices = list(jax.devices()[:4])
    for r, got in enumerate(results):
        d, s = np.argwhere(jmesh.devices == devices[r])[0]
        assert (got["rank"], got["data_index"], got["spatial_index"]) == (
            r, d, s)
        assert got["shape"] == dict(jmesh.shape)
        assert got["device"] == "cpu"
        assert got["data_ranks"] == tuple(
            devices.index(x) for x in jmesh.devices[:, s])
        assert got["spatial_ranks"] == tuple(
            devices.index(x) for x in jmesh.devices[d, :])
        assert got["data_sum"] == sum(got["data_ranks"])
        assert got["spatial_sum"] == sum(got["spatial_ranks"])
        assert got["gathered"] == [float(x) for x in got["spatial_ranks"]]


def test_collectives_agree(run):
    _, _, _, results = run
    for got in results:
        assert got["every"] == [True, False]
        assert got["any"] is True
        assert got["broadcast"] == {"rank": 0}
        np.testing.assert_array_equal(got["replicated"],
                                      np.zeros((2, 3), np.float32))
        assert got["from_config"][0] == {DATA_AXIS: 2, SPATIAL_AXIS: 2}
        assert got["from_config"][1:] == (got["data_index"],
                                          got["spatial_index"])
        assert got["one_by_one"] is None


def test_shard_batch_matches_jax(run):
    _, _, batch, results = run
    sharded = jax_shard_batch(batch, _jax_mesh())
    for r, got in enumerate(results):
        dev = jax.devices()[r]
        for k, arr in sharded.items():
            want = next(np.asarray(sh.data) for sh in arr.addressable_shards
                        if sh.device == dev)
            np.testing.assert_array_equal(got["shard"][k], want, err_msg=k)
        # micro-batches: this rank's slice of each global micro-batch
        lo = got["data_index"] * 2
        assert got["micro"] == [lo, lo + 1, 4 + lo, 4 + lo + 1]


@pytest.mark.parametrize("mode", ["spatial", "scenes", "ensemble",
                                  "fullconv"])
def test_predict_cli_mesh_equals_one_process(run, mode):
    tmp, configs, _, _ = run
    cfg = dict(configs[mode])
    del cfg["mesh"]
    predict_cli.predict(_outputs(cfg, tmp / mode, "single"))
    mesh_dir, single_dir = tmp / mode / "mesh", tmp / mode / "single"
    tiles = sorted(p.name for p in (single_dir / "patches").glob("*.png"))
    assert tiles and tiles == sorted(
        p.name for p in (mesh_dir / "patches").glob("*.png"))
    maps = sorted(p.name for p in single_dir.glob("map*.png"))
    assert maps == sorted(p.name for p in mesh_dir.glob("map*.png"))
    for rel in [f"patches/{t}" for t in tiles] + maps:
        np.testing.assert_array_equal(
            np.asarray(Image.open(mesh_dir / rel)),
            np.asarray(Image.open(single_dir / rel)), err_msg=rel)
    if mode == "scenes":
        assert len(maps) == 5 and len(tiles) == 5 * 4


def test_serve_mesh_equals_one_process(run):
    from cvcs_tpu_torch.cli import serve as serve_cli

    tmp, _, _, results = run
    assert [got["served"] for got in results] == [3] * 4
    assert serve_cli.serve(_serve_cfg(tmp / "watch", tmp / "served")) == 3
    mesh_out, single_out = tmp / "served_mesh", tmp / "served"
    for name in ("a_mask.png", "b_mask.png", "c_mask.png"):
        np.testing.assert_array_equal(np.asarray(Image.open(mesh_out / name)),
                                      np.asarray(Image.open(single_out / name)),
                                      err_msg=name)

    def journal(out):
        return [{k: e[k] for k in ("name", "mask", "shape", "batch")}
                for e in map(json.loads, (out / "manifest.jsonl")
                             .read_text().splitlines())]

    assert journal(mesh_out) == journal(single_out)
    assert [e["batch"] for e in journal(mesh_out)] == [2, 2, 1]
