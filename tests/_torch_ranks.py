"""Rank bodies of the port's multi-process CPU tests (``test_torch_mesh``,
``test_torch_halo``, ``test_torch_dp``).

:func:`launch` runs a body in ``world`` gloo ranks started by
``torch.multiprocessing`` over a ``file://`` rendezvous under the test's
temporary directory (so parallel pytest workers never share a port), one
intra-op thread each. Each rank returns a picklable result; rank 0's
results come back whole, so a body returns large arrays from rank 0 only.
This module imports torch and the port alone: the JAX references are
computed in the pytest process.
"""

from __future__ import annotations

import pickle
import time
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

NC = 16   # classes of the fake models


def launch(body, world: int, tmp_path, *args, timeout: float = 600) -> list:
    """``body(rank, world, *args)`` in ``world`` ranks; each rank's return
    value, in rank order. A rank that fails fails the launch; ranks still
    running after ``timeout`` seconds (a collective that never matched)
    are killed and the launch raises."""
    out = Path(tmp_path) / f"ranks-{uuid.uuid4().hex[:8]}"
    out.mkdir(parents=True)
    ctx = mp.start_processes(_entry, args=(world, str(out), body, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks of {body.__name__} still "
                               f"running after {timeout} s")
    results = []
    for r in range(world):
        with open(out / f"{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, world, out, body, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/rdv",
                            rank=rank, world_size=world)
    try:
        result = body(rank, world, *args)
        with open(Path(out) / f"{rank}.pkl", "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def mesh(data=None, spatial=1):
    from cvcs_tpu_torch.core.mesh import MeshConfig, create_mesh

    return create_mesh(MeshConfig(data=data, spatial=spatial), device="cpu")


# -- fake models: the label rides in channel 0 of the window --------------
def identity_model(x):
    """Class = channel 0 of the pixel, one-hot as logits (the JAX
    ``tests/test_inference.py`` ``identity_apply``)."""
    lab = torch.clamp(torch.round(x[..., 0]), 0, NC - 1).long()
    return torch.nn.functional.one_hot(lab, NC).float()


def blur_model(x):
    """3x3 box mean of channel 0, rounded (``blur_apply``): the labels
    depend on neighbouring pixels, so an overhang changes them."""
    s = x[..., 0].float()
    acc = torch.zeros_like(s)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + torch.roll(s, (dy, dx), dims=(-2, -1))
    lab = torch.clamp(torch.round(acc / 9.0), 0, NC - 1).long()
    return torch.nn.functional.one_hot(lab, NC).float()


def segmenter(model, **cfg):
    from cvcs_tpu_torch.infer import InferenceConfig, SceneSegmenter

    if isinstance(model, dict):   # JAX variables of a tiny SwinUNet
        model = swin_model(model)
    return SceneSegmenter(model, InferenceConfig(**cfg), device="cpu")


def swin_model(variables, dims=(8, 16, 32, 64), depths=(1, 1, 2, 1),
               heads=(1, 2, 4, 8), window=4, num_classes=5):
    from cvcs_tpu_torch.models.swin import SwinUNet
    from cvcs_tpu_torch.weights import swin_state_dict

    model = SwinUNet(num_classes, in_channels=3, dtype=torch.float32,
                     dims=dims, depths=depths, heads=heads, window=window)
    model.load_state_dict(swin_state_dict(variables, depths), strict=True)
    return model.eval()


# -- test_torch_halo ---------------------------------------------------------
def halo_body(rank, world, cases):
    """``cases``: the halo strips and the scene-path cases. Returns, per
    case, the rank's halo-extended strips and the labels of each sharded
    engine path (whole maps: every rank gets them; rank 0 returns them,
    the others their digest)."""
    from cvcs_tpu_torch.parallel.halo import exchange_row_halo

    out = {}
    m_sp = mesh(data=1, spatial=world)
    for name, (strips, halo, axis) in cases["halo"].items():
        out[name] = exchange_row_halo(torch.from_numpy(strips[rank]), halo,
                                      m_sp, axis=axis).numpy()
    meshes = {"sp": m_sp, "scenes": mesh(data=2, spatial=world // 2)}
    for name, (kind, model, cfg, mesh_name, scene, kw) in \
            cases["engine"].items():
        seg = segmenter(model, **cfg)
        m = meshes[mesh_name]
        fn = {"scene": seg.predict_scene_sharded,
              "scenes": seg.predict_scenes_sharded,
              "fullconv": seg.predict_scene_fullconv_sharded}[kind]
        lab = fn(scene, m, **kw).numpy()
        out[name] = lab if rank == 0 else int(lab.astype(np.int64).sum())
    return out


# -- test_torch_mesh ---------------------------------------------------------
def mesh_body(rank, world, batch, configs, serve_cfg):
    """The 2 x 2 mesh's layout and collectives, ``shard_batch``,
    ``replicate``, ``mesh_from_config``, then ``cli.predict`` with each
    ``configs`` entry and ``cli.serve`` with ``serve_cfg`` (rank 0 writes
    the outputs)."""
    from cvcs_tpu_torch.cli import common
    from cvcs_tpu_torch.cli import predict as predict_cli
    from cvcs_tpu_torch.cli import serve as serve_cli
    from cvcs_tpu_torch.core import mesh as mesh_lib

    m = mesh(data=2, spatial=2)
    one = torch.tensor([float(rank)])
    out = dict(
        rank=m.rank, data_index=m.data_index, spatial_index=m.spatial_index,
        data_ranks=m.data_ranks, spatial_ranks=m.spatial_ranks,
        shape=dict(m.shape), device=str(m.device),
        data_sum=float(mesh_lib.all_reduce_sum(one, m.data_group)),
        spatial_sum=float(mesh_lib.all_reduce_sum(one, m.spatial_group)),
        gathered=mesh_lib.all_gather_cat(one, m.spatial_group).tolist(),
        every=mesh_lib.every_rank([True, rank != 3], m),
        any=mesh_lib.any_rank(rank == 2, m),
        broadcast=mesh_lib.broadcast_object({"rank": rank}, m),
        shard={k: (None if v is None else v.numpy())
               for k, v in mesh_lib.shard_batch(
                   {k: torch.from_numpy(v) for k, v in batch.items()},
                   m).items()},
        micro=mesh_lib.shard_batch(torch.arange(8), m, micro=2).tolist())
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(rank))
    out["replicated"] = mesh_lib.replicate(lin, m).weight.detach().numpy()
    from_cfg = common.mesh_from_config({"mesh": {"data": None,
                                                 "spatial": 2}}, "cpu")
    out["from_config"] = (dict(from_cfg.shape), from_cfg.data_index,
                          from_cfg.spatial_index)
    out["one_by_one"] = common.mesh_from_config({"mesh": {}}, "cpu")
    for cfg in configs:
        predict_cli.predict(cfg)
    out["served"] = serve_cli.serve(serve_cfg)
    return out


# -- test_torch_dp -----------------------------------------------------------
def unet_from(state_dict):
    """Full-width Unet (f32, on the CPU) holding ``state_dict``."""
    from cvcs_tpu_torch.models.unet import UNet

    model = UNet(NC, dtype=torch.float32)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def dp_state(model) -> dict:
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def dp_step(model, start, image, mask, loss, accum, m=None, weights=None):
    """One SGD2 step of ``model`` reset to the state dict ``start``, on
    ``image``/``mask`` (this rank's share of the global batch when ``m``
    is a data mesh). ``loss``: "CEL", "wCEL" (``ignore_background``) or
    "fused" (``build_fused_ce`` with the wCEL weights,
    ``ignore_background``). Returns (loss, state)."""
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.ops.fused_ce import build_fused_ce
    from cvcs_tpu_torch.ops.losses import build_loss
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    model.load_state_dict(start, strict=True)
    state = TrainState(model, build_optimizer("SGD2", model.parameters()))
    state.optimizer.set_epoch(0)
    if loss == "fused":
        fn = build_fused_ce(weights, ignore_background=True, device="cpu")
    else:
        fn = build_loss(loss, weights=weights,
                        ignore_background=loss == "wCEL", device="cpu")
    image, mask = torch.from_numpy(image), torch.from_numpy(mask)
    if m is not None:
        image, mask = mesh_lib.shard_batch((image, mask), m, micro=accum)
    got = train_step(state, fn, image, mask, accum=accum, mesh=m)
    return float(got), dp_state(model)


def digest(state: dict) -> float:
    return float(sum(np.abs(v).astype(np.float64).sum()
                     for v in state.values()))


def dp_body(rank, world, start_path, steps, bn_case):
    """Each of ``steps`` (name -> (image, mask, loss, accum, weights)) as
    a data-parallel step over all ranks from the Unet state dict saved at
    ``start_path``; rank 0 returns the states, every rank its losses and
    a digest of its states (the ranks must agree). ``bn_case``:
    train-mode BatchNorm on this rank's rows of one global (N, C) batch
    under ``data_parallel``."""
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.models.blocks import batch_norm_train

    m = mesh(data=world)
    start = torch.load(start_path, weights_only=True)
    model = unet_from(start)
    out = {}
    for name, (image, mask, loss, accum, weights) in steps.items():
        value, state = dp_step(model, start, image, mask, loss, accum, m,
                               weights)
        out[name] = (value, state if rank == 0 else None, digest(state))
    x, momentum = bn_case
    bn = torch.nn.BatchNorm2d(x.shape[1], momentum=momentum)
    with torch.no_grad(), mesh_lib.data_parallel(m):
        mine = mesh_lib.shard_batch(torch.from_numpy(x), m)
        batch_norm_train(mine[:, None, None, :], bn)
    out["bn"] = (bn.running_mean.numpy().copy(),
                 bn.running_var.numpy().copy())
    return out


def train_cli_body(rank, world, cfg, eval_cfg):
    """``cli.train`` over a data mesh for ``cfg['epochs']`` epochs, then a
    resume for one more with ``load_checkpoint: auto``, then
    ``cli.evaluate`` of the last checkpoint, all with ``mesh: {data:
    world}``. Returns the losses and the evaluation's metrics."""
    from cvcs_tpu_torch.cli import evaluate as evaluate_cli
    from cvcs_tpu_torch.cli import train as train_cli

    cfg = dict(cfg, mesh={"data": world})
    first = train_cli.build_trainer(cfg)
    first.train()
    resumed = train_cli.build_trainer(dict(cfg, epochs=cfg["epochs"] + 1,
                                           load_checkpoint="auto"))
    resumed.train()
    metrics = evaluate_cli.evaluate(dict(eval_cfg, mesh={"data": world}))
    return dict(train=first.training_loss_values,
                val=first.validation_loss_values,
                resumed_from=resumed.last_epoch,
                resumed_train=resumed.training_loss_values,
                metrics=metrics)
