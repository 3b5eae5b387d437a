"""The JAX package's Orbax checkpoints, read into the port.

``cvcs_tpu/train/checkpoint.py`` writes ``checkpointN/state/`` with Orbax:
the tree ``{params, batch_stats, opt_state, step}`` as zarr arrays in an
OCDBT key-value store (``manifest.ocdbt``, ``ocdbt.process_0/``), and the
tree's structure in ``_METADATA``. :func:`read_state_tree` rebuilds that
tree as numpy arrays from ``_METADATA`` alone (no template: Orbax stores
optax's tuples as lists and its named tuples as dicts, and ``_METADATA``
says which), reading each array with ``tensorstore``, which is imported
only there. Without ``tensorstore`` it raises ``ImportError`` naming the
other route: ``python -m cvcs_tpu.cli.export`` turns such a directory into
a ``.pt`` state dict on a host with the JAX package.

:func:`load_orbax_state` restores a port ``TrainState`` from one:

* the weights and BatchNorm statistics through the JAX bridge
  (:func:`cvcs_tpu_torch.weights.jax_state_dict`);
* the optimizer state: optax ``trace`` (SGD1/SGD2) becomes SGD's
  ``momentum_buffer``, ``scale_by_adam``'s ``count``, ``mu`` and ``nu``
  (ADAM1) become Adam's ``step``, ``exp_avg`` and ``exp_avg_sq``. A
  moment tree has its parameters' layout, so it goes through the same
  bridge as the parameters (HWIO -> OIHW, a conv-transpose's transpose
  and spatial flip), with the checkpoint's ``batch_stats`` beside it;
* the step count.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

STATE_DIR = "state"
METADATA = "_METADATA"
_SEQUENCE = 1        # _METADATA key_type of a list / tuple index


def is_orbax_checkpoint(path) -> bool:
    return (Path(path) / STATE_DIR / METADATA).is_file()


def _open_array(ts, directory: Path, name: str, meta: dict):
    kvstore = {"driver": "ocdbt", "path": name,
               "base": {"driver": "file", "path": str(directory)}}
    zarr = "zarr3" if meta.get("use_zarr3") else "zarr"
    return ts.open({"driver": zarr, "kvstore": kvstore}, open=True).result()


class _Node(dict):
    """A tree level; ``is_sequence`` when its keys are list indices."""

    is_sequence = False


def _listify(node):
    """Turn the dicts that stand for sequences back into lists."""
    if isinstance(node, dict):
        out = {k: _listify(v) for k, v in node.items()}
        if node.is_sequence:
            return [out[k] for k in sorted(out, key=int)]
        return out
    return node


def read_state_tree(path, roots: tuple[str, ...] | None = None) -> dict:
    """``checkpointN/`` (or its ``state/``) -> the saved tree, numpy
    leaves; ``roots`` keeps only those top-level entries (``("params",
    "batch_stats")`` reads no optimizer state)."""
    try:
        import tensorstore as ts
    except ImportError as err:
        raise ImportError(
            "reading the JAX package's Orbax checkpoints needs the "
            "tensorstore package, which this host lacks; on a host with the "
            "JAX package, `python -m cvcs_tpu.cli.export <config>` writes "
            "such a checkpoint as a .pt state dict, which the port loads"
        ) from err
    directory = Path(path)
    if directory.name != STATE_DIR:
        directory = directory / STATE_DIR
    meta = json.loads((directory / METADATA).read_text())
    if not meta.get("use_ocdbt", True):
        raise ValueError(f"{directory} is not an OCDBT store, which the JAX "
                         "package's checkpoints are")
    tree = _Node()
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        if roots is not None and keys[0]["key"] not in roots:
            continue
        node = tree
        for k, nxt in zip(keys, keys[1:]):
            node = node.setdefault(str(k["key"]), _Node())
            node.is_sequence = nxt["key_type"] == _SEQUENCE
        value = entry["value_metadata"]
        leaf = None
        if not value.get("skip_deserialize"):
            name = ".".join(str(k["key"]) for k in keys)
            leaf = np.asarray(_open_array(ts, directory, name, meta)
                              .read().result())
        node[str(keys[-1]["key"])] = leaf
    return _listify(tree)


def orbax_variables(path) -> dict:
    """The model variables ``{"params", "batch_stats"}`` of an Orbax
    checkpoint (``batch_stats`` empty for a net without BatchNorm)."""
    tree = read_state_tree(path, ("params", "batch_stats"))
    return {"params": tree["params"],
            "batch_stats": tree.get("batch_stats") or {}}


def _moments(opt_state) -> dict:
    """The optax state's moment trees by torch state name, and Adam's
    count: ``{"momentum_buffer": tree}`` or ``{"exp_avg": mu,
    "exp_avg_sq": nu, "step": count}``."""
    parts = opt_state if isinstance(opt_state, list) else [opt_state]
    for part in parts:
        if isinstance(part, dict) and "trace" in part:
            return {"momentum_buffer": part["trace"]}
        if isinstance(part, dict) and {"count", "mu", "nu"} <= set(part):
            return {"exp_avg": part["mu"], "exp_avg_sq": part["nu"],
                    "step": part["count"]}
    raise ValueError("the checkpoint's optimizer state holds neither an "
                     "optax trace nor a scale_by_adam state")


def load_orbax_state(path, state):
    """Restore ``state`` (model, optimizer, step) in place from a JAX
    package ``checkpointN/``; return it."""
    from cvcs_tpu_torch.weights import jax_state_dict

    tree = read_state_tree(path)
    stats = tree.get("batch_stats") or {}
    model = state.model
    model.load_state_dict(
        jax_state_dict(model, {"params": tree["params"],
                               "batch_stats": stats}), strict=True)
    moments = _moments(tree["opt_state"])
    count = moments.pop("step", None)
    named = dict(model.named_parameters())
    by_name = {k: jax_state_dict(model, {"params": t, "batch_stats": stats})
               for k, t in moments.items()}
    opt = state.optimizer.opt
    opt.state.clear()
    names = {id(p): n for n, p in named.items()}
    for group in opt.param_groups:
        for p in group["params"]:
            n = names[id(p)]
            entry = {k: sd[n].to(device=p.device, dtype=p.dtype)
                     for k, sd in by_name.items()}
            if count is not None:
                entry["step"] = torch.tensor(float(count),
                                             dtype=torch.float32)
            opt.state[p] = entry
    state.step = int(tree["step"])
    return state
