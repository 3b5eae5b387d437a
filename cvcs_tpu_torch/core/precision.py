"""Mixed-precision policy (port of ``cvcs_tpu/core/precision.py``).

Parameters and batch-norm statistics live in float32, compute runs in
bfloat16, outputs (logits) come back in float32. ``precision: f32`` runs
compute in float32 too.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = Policy()
F32_POLICY = Policy(compute_dtype=torch.float32)


def policy_from_config(name: str | None) -> Policy:
    if name in (None, "bf16", "bfloat16", "mixed"):
        return DEFAULT_POLICY
    if name in ("f32", "float32", "full"):
        return F32_POLICY
    raise ValueError(f"unknown precision policy: {name!r}")
