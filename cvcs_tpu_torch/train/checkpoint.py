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

Both files are written to a temporary name and renamed, ``meta.json``
first and ``state.pt`` last, so a checkpoint without ``state.pt`` is one
still being written (or torn by a crash), and :func:`latest_checkpoint`
and :func:`prune_checkpoints` pass it by.

``async_save=True`` (the train config's ``async_checkpoints``) copies the
model's and the optimizer's state to host memory (pinned buffers, one
synchronisation: torch updates parameters and momentum buffers in place,
so the next step must not reach the copy) and leaves ``torch.save`` and
the renames to a writer thread, at most one write in flight;
:func:`wait_for_saves` blocks until it has landed.

:func:`load_checkpoint` also restores the JAX package's Orbax
directories (``checkpointN/state/``, see
:mod:`cvcs_tpu_torch.train.orbax_read`): weights, BatchNorm statistics,
optimizer state and step, with the same ``meta.json``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cvcs_tpu_torch.train import orbax_read

_CKPT_RE = re.compile(r"^checkpoint(\d+)(_preempt)?$")
STATE = "state.pt"
STATE_KEYS = {"model", "optimizer", "step"}   # the entries of state.pt


def _jsonable(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


_writer: ThreadPoolExecutor | None = None
_in_flight: Future | None = None


def wait_for_saves() -> None:
    """Block until the write in flight (if any) has landed; re-raise its
    error."""
    global _in_flight
    if _in_flight is not None:
        pending, _in_flight = _in_flight, None
        pending.result()


def host_copy(obj):
    """``obj`` with every tensor copied to host memory: CUDA tensors into
    pinned buffers, enqueued on the current stream and waited for once;
    CPU tensors cloned."""
    cuda = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                cuda.append(x.device)
                return buf.copy_(x.detach(), non_blocking=True)
            return x.detach().clone()
        if isinstance(x, dict):
            return type(x)((k, walk(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return x

    out = walk(obj)
    if cuda:
        torch.cuda.current_stream(cuda[0]).synchronize()
    return out


def _write(path: Path, payload: dict, meta: dict) -> None:
    tmp = path / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path / "meta.json")
    tmp = path / f"{STATE}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path / STATE)


def save_checkpoint(directory: str | Path, epoch: int, state,
                    train_loss: list[float], val_loss: list[float],
                    batch_size: int, optimizer: str, conf_flat: Any = None,
                    conf_normalized: Any = None, tag: str = "",
                    async_save: bool = False) -> Path:
    """Write ``<directory>/checkpoint{epoch+1}{tag}``; with
    ``async_save`` return once the state is copied to the host, the write
    going on in a thread (see :func:`wait_for_saves`)."""
    global _writer, _in_flight
    path = Path(directory) / f"checkpoint{epoch + 1}{tag}"
    path.mkdir(parents=True, exist_ok=True)
    payload = {"model": state.model.state_dict(),
               "optimizer": state.optimizer.opt.state_dict(),
               "step": state.step}
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
    wait_for_saves()                      # at most one write in flight
    # a checkpoint written again is incomplete until its state.pt lands
    (path / STATE).unlink(missing_ok=True)
    if not async_save:
        _write(path, payload, meta)
        return path
    payload = host_copy(payload)
    if _writer is None:
        _writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
    _in_flight = _writer.submit(_write, path, payload, meta)
    return path


def load_checkpoint(path: str | Path, state):
    """Restore ``state`` (model, optimizer, step) in place from ``path``,
    a checkpoint of the port or an Orbax one of the JAX package; return
    ``(state, meta)``. A missing or corrupt ``meta.json`` restores the
    weights with empty metadata, as the reference does for old
    checkpoints."""
    path = Path(path)
    if (path / STATE).is_file():
        dev = next(state.model.parameters()).device
        saved = torch.load(path / STATE, map_location=dev, weights_only=True)
        state.model.load_state_dict(saved["model"], strict=True)
        state.optimizer.opt.load_state_dict(saved["optimizer"])
        state.step = int(saved["step"])
    elif orbax_read.is_orbax_checkpoint(path):
        orbax_read.load_orbax_state(path, state)
    else:
        raise FileNotFoundError(f"no {STATE} and no Orbax state/ under {path}")
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
    """Complete checkpoints, oldest first: the port's (``state.pt``
    written) and the JAX package's Orbax ones (``state/`` landed, as
    ``orbax_read.is_orbax_checkpoint`` says), ranked alike, as the JAX
    rule ranks its own (``cvcs_tpu/train/checkpoint.py:200-225``):
    ``checkpoint{N}_preempt`` (mid epoch N) after ``checkpoint{N}`` and
    before ``checkpoint{N+1}``. A half-written one (an
    ``*.orbax-checkpoint-tmp-*`` directory, or ``meta.json`` alone) is
    passed by."""
    if not directory.is_dir():
        return []
    out = []
    for child in directory.iterdir():
        m = _CKPT_RE.match(child.name)
        if m and ((child / STATE).is_file()
                  or orbax_read.is_orbax_checkpoint(child)):
            out.append(((int(m.group(1)), 1 if m.group(2) else 0), child))
    return sorted(out)


def latest_checkpoint(directory: str | Path) -> Path | None:
    """The newest complete checkpoint under ``directory`` (the port's or
    an Orbax one of the JAX package), or None."""
    ranked = _ranked(Path(directory))
    return ranked[-1][1] if ranked else None


def prune_checkpoints(directory: str | Path, keep: int) -> list[Path]:
    """Delete all but the newest ``keep`` complete checkpoints, Orbax ones
    of the JAX package included, as its prune deletes them; return the
    deleted paths. A half-written checkpoint is neither counted nor
    touched."""
    if keep < 1:
        return []
    doomed = [c for _, c in _ranked(Path(directory))[:-keep]]
    for c in doomed:
        shutil.rmtree(c)
    return doomed
