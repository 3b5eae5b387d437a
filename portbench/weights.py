"""Weights and seeds made by the benchmark from ``--seed``.

The weights of a configuration are drawn on the device in one call of
one ``torch.Generator`` and cut into the leaves that the configuration's
reference lists (:func:`portbench.reference.<config>.param_specs`), in
float32, the type the program holds its parameters in: lecun-normal
kernels, small random biases and norm affines around the identity, and
fresh running statistics. The same dict goes to the program (copied into
its model) and to the plain reference, so both compute with the same
numbers and neither takes anything the other made.
"""

from __future__ import annotations

import numpy as np
import torch

BIAS_STD = 0.02
NORM_STD = 0.1


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each named use of ``--seed``."""
    key = [int(b) for b in stream.encode()]
    state = np.random.SeedSequence([seed % 2**64, *key]).generate_state(
        2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def generator(seed: int, stream: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, stream))
    return gen


def make_weights(specs: list[tuple], seed: int, device) -> dict:
    """name -> float32 tensor for every (name, shape, kind, fan-in) of
    ``specs``, drawn in one call from the seed."""
    sizes = [int(np.prod(shape)) for _, shape, _, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, "weights",
                                                       device),
                       device=device)
    out = {}
    for (name, shape, kind, fan), piece in zip(specs, flat.split(sizes)):
        r = piece.view(shape)
        if kind == "weight":
            out[name] = r * fan ** -0.5
        elif kind == "bias":
            out[name] = r * BIAS_STD
        elif kind == "norm_w":
            out[name] = 1.0 + r * NORM_STD
        elif kind == "norm_b":
            out[name] = r * NORM_STD
        elif kind == "mean":
            out[name] = torch.zeros_like(r)
        elif kind == "var":
            out[name] = torch.ones_like(r)
        else:
            raise ValueError(f"unknown kind {kind!r} of {name}")
    return out


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: dict) -> None:
    """Copy ``weights`` into the program's model. Its floating-point
    parameters and buffers must be exactly the reference's leaves, by
    name and shape; its integer buffers (BatchNorm's batch counters) are
    left as they are."""
    sd = model.state_dict()
    floats = {k for k, v in sd.items() if v.is_floating_point()}
    if floats != set(weights):
        raise ValueError(
            f"the model's float leaves differ from the reference's: only "
            f"the model's {sorted(floats - set(weights))[:5]}, only the "
            f"reference's {sorted(set(weights) - floats)[:5]}")
    for k in floats:
        if tuple(sd[k].shape) != tuple(weights[k].shape):
            raise ValueError(f"{k}: model {tuple(sd[k].shape)}, reference "
                             f"{tuple(weights[k].shape)}")
        sd[k].copy_(weights[k])
