"""Shared CLI plumbing (port of ``cvcs_tpu/cli/common.py``): device and
mesh selection, model construction from a config dict, checkpoint
restore, ensemble assembly, label fetch and same-shape raster batching.

A config's ``mesh: {data: D, spatial: S}`` lays the ranks of a
``torchrun`` (or ``torch.multiprocessing``) launch out as
:mod:`cvcs_tpu_torch.core.mesh` describes: ``python -m torch.distributed.run
--nproc-per-node N -m cvcs_tpu_torch.cli.predict cfg.yaml`` runs one rank
per card. Every rank runs the same sequence of collectives; rank 0 alone
writes the outputs."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from cvcs_tpu_torch.core import mesh as mesh_lib
from cvcs_tpu_torch.core.device import resolve_device
from cvcs_tpu_torch.core.precision import policy_from_config
from cvcs_tpu_torch.infer.engine import labels_to_host
from cvcs_tpu_torch.models import MODEL_REGISTRY, ModelSpec, build_model
from cvcs_tpu_torch.models.ensemble import Ensemble, EnsembleMember
from cvcs_tpu_torch.train import orbax_read
from cvcs_tpu_torch.train.checkpoint import STATE, STATE_KEYS
from cvcs_tpu_torch.utils import torch_import
from cvcs_tpu_torch.weights import load_jax_variables, unflatten_npz

def device_context(config: dict) -> torch.device:
    """The device a config selects: ``device: cpu`` the CPU, any other
    value or none the card (raises when there is none)."""
    return resolve_device("cpu" if config.get("device") == "cpu" else None)


def mesh_from_config(config: dict, device: torch.device):
    """The mesh a config's ``mesh`` asks for (JAX ``cli/common.py:28-33``),
    over the ranks of the default group, which is initialised from
    ``torchrun``'s environment when none exists; ``data: null`` means
    every rank the spatial axis leaves. A 1x1 mesh is no mesh (None). In
    a single process a mesh over more ranks raises ``MeshConfig.resolve``'s
    ``ValueError``, as JAX raises over too few devices. The caller then
    runs on ``mesh.device``."""
    m = config.get("mesh") or {}
    if not m:
        return None
    cfg = mesh_lib.MeshConfig(data=m.get("data"),
                              spatial=int(m.get("spatial", 1)))
    data, spatial = cfg.resolve(mesh_lib.world()[1])
    if data * spatial == 1:
        return None
    return mesh_lib.create_mesh(cfg, device)


def is_lead(mesh) -> bool:
    """Whether this rank writes the outputs (rank 0, or no mesh)."""
    return mesh is None or mesh.rank == 0


def model_dtypes(config: dict) -> dict:
    return dict(dtype=policy_from_config(config.get("precision")).compute_dtype)


def build_net(config: dict, device=None, seed: int = 0):
    """Model + spec from config names, seeded-initialised on ``device``;
    like the reference, builds with num_classes + 1 for background.

    ``remat: true`` (train configs) builds the model with block-level
    rematerialisation; a net without a ``remat`` argument rejects it."""
    name = config["net"]
    num_classes = int(config.get("num_classes", 15)) + 1
    kw = dict(device=device, seed=seed,
              in_channels=int(config.get("in_channels", 3)),
              **model_dtypes(config))
    if config.get("remat"):
        try:
            model, spec = build_model(name, num_classes, remat=True, **kw)
        except TypeError as e:
            if "remat" not in str(e):
                raise  # a genuine construction error, not lack of support
            raise ValueError(
                f"remat: true is not supported for net {name!r} "
                "(block-level rematerialization is implemented for the "
                "UNet family); use grad_accum") from None
        return model, spec, num_classes
    model, spec = build_model(name, num_classes, **kw)
    return model, spec, num_classes


def restore_variables(config: dict, model):
    """Overwrite the model's weights from ``config['load_checkpoint']``:

    * a train checkpoint of the port (a ``checkpointN/`` directory, or its
      ``state.pt``) or a port state dict saved with ``torch.save``;
    * a JAX package Orbax ``checkpointN/`` (holding ``state/``; see
      :mod:`cvcs_tpu_torch.train.orbax_read`);
    * an ``.npz`` of JAX variables (see :mod:`cvcs_tpu_torch.weights`);
    * a reference ``torch.save`` pickle, the 12-key dict with the
      wrappers' prefixes, for the nets the JAX package imports (see
      :mod:`cvcs_tpu_torch.utils.torch_import`)."""
    ckpt = config.get("load_checkpoint")
    if not ckpt:
        return model
    path = Path(ckpt)
    if path.is_dir() and not (path / STATE).is_file():
        if not orbax_read.is_orbax_checkpoint(path):
            raise FileNotFoundError(
                f"no {STATE} and no Orbax state/ under {ckpt}")
        load_jax_variables(model, orbax_read.orbax_variables(path))
    elif path.suffix == ".npz":
        with np.load(path) as arrays:
            load_jax_variables(model, unflatten_npz(arrays))
    else:
        sd = torch_import.load_pickle(path / STATE if path.is_dir() else path)
        if torch_import.is_reference_checkpoint(sd):
            sd = torch_import.reference_state_dict(sd, config["net"])
        elif isinstance(sd, dict) and set(sd) == STATE_KEYS:
            sd = sd["model"]
        model.load_state_dict(sd, strict=True)
    print(f"Loaded checkpoint {ckpt}", flush=True)
    return model


def build_ensemble(config: dict, device=None) -> Ensemble:
    """The majority-vote ensemble of an ``ensemble_config`` file, a YAML
    map of net name -> checkpoint (``configs/ensemble_test.yaml``). Each
    member is built on ``device`` and restored from its own checkpoint,
    anything :func:`restore_variables` takes, and runs in eval mode."""
    import yaml

    path = config.get("ensemble_config")
    if not path:
        raise ValueError(
            "To use the ensemble specify 'ensemble_config' in your "
            "evaluation configuration file.")
    with open(path) as f:
        members_cfg = yaml.safe_load(f)
    num_classes = int(config.get("num_classes", 15)) + 1
    members = []
    for net_name, ckpt in members_cfg.items():
        m_config = dict(config, net=net_name, load_checkpoint=ckpt)
        model, spec, _ = build_net(m_config, device)
        restore_variables(m_config, model)
        members.append(EnsembleMember(net_name, model.eval(),
                                      returns_logits=spec.returns_logits))
    return Ensemble(members, num_classes)


def build_apply(config: dict, device=None):
    """``(model, spec, num_classes)`` for a config's net, seeded, then
    weights restored from ``load_checkpoint`` if given. ``net: Ensemble``
    gives the :func:`build_ensemble` vote, with a spec whose
    ``stride_product`` is the largest of its members' (all powers of
    two, so also their least common multiple)."""
    if config.get("net") == "Ensemble":
        ens = build_ensemble(config, device)
        stride = max(MODEL_REGISTRY[m.name].stride_product
                     for m in ens.members)
        spec = ModelSpec("Ensemble", Ensemble,
                         returns_logits=ens.returns_logits,
                         wrapper=ens.wrapper, stride_product=stride)
        return ens, spec, ens.num_classes
    model, spec, num_classes = build_net(config, device)
    restore_variables(config, model)
    return model, spec, num_classes


def resolve_config_arg(argv) -> dict:
    from cvcs_tpu_torch.config.loader import display_configs, load_yaml

    if len(argv) < 2:
        raise SystemExit(f"usage: {Path(argv[0]).name} <config.yaml>")
    config = load_yaml(argv[1])
    display_configs(config)
    return config


def fetch_labels(labels) -> list:
    """Label maps (device tensors or host arrays) -> host uint8 arrays."""
    return [labels_to_host(lab) for lab in labels]


def segment_rasters(seg, rasters, mesh=None) -> list:
    """Per-raster label maps; same-shape rasters run as one batched
    multi-scene pass. With a mesh (JAX ``cli/common.py:187-208``), full
    groups of ``data`` rasters run scene-parallel
    (``predict_scenes_sharded``: scenes over the data axis, rows over the
    spatial axis) and the rest one by one with their rows over the
    spatial axis (``predict_scene_sharded``)."""
    def one(r):
        return (seg.predict_scene_sharded(r, mesh) if mesh is not None
                else seg.predict_scene(r))

    if len(rasters) > 1 and len({r.shape for r in rasters}) == 1:
        if mesh is not None:
            n_data = mesh.shape[mesh_lib.DATA_AXIS]
            full = len(rasters) - len(rasters) % n_data
            per_scene = (list(seg.predict_scenes_sharded(
                rasters[:full], mesh)) if full else [])
            return per_scene + [one(r) for r in rasters[full:]]
        return list(seg.predict_scenes(rasters))
    return [one(r) for r in rasters]
