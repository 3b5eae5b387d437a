"""Checkpoint and resume (port of ``cvcs_tpu/train/checkpoint.py``).

A checkpoint is a directory ``checkpoint{epoch+1}`` (``checkpoint{N}_preempt``
for a save made mid-epoch on preemption), the JAX package's names,
holding

* ``state.pt``: ``torch.save`` of the model's state dict (parameters and
  BatchNorm running statistics), the optimizer's state dict and the step
  count;
* ``meta.json``: epoch, training and validation loss histories,
  batch_size (which resume imposes over the config, as the reference
  does), the optimizer name, and the flat and row-normalised confusion
  histories.

Both files are written to a temporary name and renamed, so a crash never
leaves a torn checkpoint that :func:`latest_checkpoint` would pick. The
JAX package's Orbax directories (a ``state/`` directory) are refused.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

_CKPT_RE = re.compile(r"^checkpoint(\d+)(_preempt)?$")
STATE = "state.pt"
STATE_KEYS = {"model", "optimizer", "step"}   # the entries of state.pt


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def save_checkpoint(directory: str | Path, epoch: int, state,
                    train_loss: list[float], val_loss: list[float],
                    batch_size: int, optimizer: str, conf_flat: Any = None,
                    conf_normalized: Any = None, tag: str = "") -> Path:
    """Write ``<directory>/checkpoint{epoch+1}{tag}``."""
    path = Path(directory) / f"checkpoint{epoch + 1}{tag}"
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{STATE}.tmp"
    torch.save({"model": state.model.state_dict(),
                "optimizer": state.optimizer.opt.state_dict(),
                "step": state.step}, tmp)
    os.replace(tmp, path / STATE)
    meta = {
        "epoch": epoch,
        "training_loss_values": [float(v) for v in train_loss],
        "validation_loss_values": [float(v) for v in val_loss],
        "batch_size": int(batch_size),
        "optimizer": optimizer,
        "conf_flat": _jsonable(conf_flat),
        "conf_normalized": _jsonable(conf_normalized),
        # deprecated in the reference, kept as keys for format parity
        "macro_precision": [],
        "weighted_precision": [],
    }
    tmp = path / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path / "meta.json")
    return path


def load_checkpoint(path: str | Path, state):
    """Restore ``state`` (model, optimizer, step) in place from ``path``;
    return ``(state, meta)``. A missing or corrupt ``meta.json`` restores
    the weights with empty metadata, as the reference does for old
    checkpoints."""
    path = Path(path)
    if not (path / STATE).is_file():
        if (path / "state").is_dir():
            raise NotImplementedError(
                f"{path} is an Orbax checkpoint of the JAX package; loading "
                "those is not yet ported (ROADMAP.md Queue 1 item 6b)")
        raise FileNotFoundError(f"no {STATE} under {path}")
    dev = next(state.model.parameters()).device
    saved = torch.load(path / STATE, map_location=dev, weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.opt.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    meta = {}
    meta_path = path / "meta.json"
    if meta_path.exists():
        try:
            meta = json.loads(meta_path.read_text())
        except json.JSONDecodeError:
            print(f"WARNING: {meta_path} is corrupt; restoring weights with "
                  "empty metadata (epoch and histories reset)", flush=True)
    return state, meta


def _ranked(directory: Path) -> list[tuple[tuple[int, int], Path]]:
    """Complete checkpoints, oldest first: ``checkpoint{N}_preempt`` (mid
    epoch N) ranks after ``checkpoint{N}`` and before ``checkpoint{N+1}``."""
    if not directory.is_dir():
        return []
    out = []
    for child in directory.iterdir():
        m = _CKPT_RE.match(child.name)
        if m and (child / STATE).is_file():
            out.append(((int(m.group(1)), 1 if m.group(2) else 0), child))
    return sorted(out)


def latest_checkpoint(directory: str | Path) -> Path | None:
    """The newest complete checkpoint under ``directory``, or None."""
    ranked = _ranked(Path(directory))
    return ranked[-1][1] if ranked else None


def prune_checkpoints(directory: str | Path, keep: int) -> list[Path]:
    """Delete all but the newest ``keep`` complete checkpoints; return the
    deleted paths."""
    if keep < 1:
        return []
    doomed = [c for _, c in _ranked(Path(directory))[:-keep]]
    for c in doomed:
        shutil.rmtree(c)
    return doomed
