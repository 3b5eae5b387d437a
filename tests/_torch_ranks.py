"""Rank bodies of the port's multi-process CPU tests (``test_torch_mesh``,
``test_torch_halo``, ``test_torch_dp``, ``test_torch_spatial``,
``test_torch_tp``).

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
    return start(body, world, tmp_path, *args).join(timeout)


class Ranks:
    """Rank processes started by :func:`start`."""

    def __init__(self, ctx, body, world: int, out: Path):
        self.ctx, self.body, self.world, self.out = ctx, body, world, out

    def kill(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()

    def join(self, timeout: float = 600) -> list:
        """Each rank's return value, in rank order (see :func:`launch`)."""
        deadline = time.monotonic() + timeout
        try:
            while not self.ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{self.world} ranks of {self.body.__name__} still "
                        f"running after {timeout} s")
        finally:
            self.kill()
        results = []
        for r in range(self.world):
            with open(self.out / f"{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results


def start(body, world: int, tmp_path, *args) -> Ranks:
    """:func:`launch` without waiting: the caller computes meanwhile,
    then calls ``join`` (or ``kill``). The arguments go through a file:
    pickled into each child's pipe, more than the pipe holds would block
    the start of every rank until the one before had imported torch."""
    out = Path(tmp_path) / f"ranks-{uuid.uuid4().hex[:8]}"
    out.mkdir(parents=True)
    with open(out / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    ctx = mp.start_processes(_entry, args=(world, str(out), body),
                             nprocs=world, join=False, start_method="spawn")
    return Ranks(ctx, body, world, out)


def _entry(rank, world, out, body):
    with open(Path(out) / "args.pkl", "rb") as f:
        args = pickle.load(f)
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


# -- test_torch_spatial --------------------------------------------------------
def spatial_step(net, start_path, image, mask, loss, weights, keep=None,
                 m=None):
    """One f32 SGD2 step of the port's ``net`` from the state dict saved
    at ``start_path`` on the global batch ``image``/``mask`` (wCEL with
    ``ignore_background``, or ``loss="fused"``: ``build_fused_ce`` with
    the same weights; ``loss="remat"``: wCEL with the net built with
    ``remat``): with a mesh ``m``, this rank's data share cut to
    its strip of rows, under ``spatial_parallel``. ``keep``: the head
    dropout's keep mask of the global batch (SegFormer). Returns (loss,
    state, the ops that took the gather)."""
    from cvcs_tpu_torch.core import mesh as mesh_lib
    from cvcs_tpu_torch.models.registry import MODEL_REGISTRY
    from cvcs_tpu_torch.ops.fused_ce import build_fused_ce
    from cvcs_tpu_torch.ops.losses import build_loss
    from cvcs_tpu_torch.parallel import halo
    from cvcs_tpu_torch.train.optim import build_optimizer
    from cvcs_tpu_torch.train.state import TrainState
    from cvcs_tpu_torch.train.step import train_step

    model = MODEL_REGISTRY[net].build(
        NC, dtype=torch.float32, **({"remat": True} if loss == "remat" else {}))
    model.load_state_dict(torch.load(start_path, weights_only=True),
                          strict=True)
    if keep is not None:
        model.decode_head.dropout.keep_mask = torch.from_numpy(keep)
    state = TrainState(model, build_optimizer("SGD2", model.parameters()))
    state.optimizer.set_epoch(0)
    fn = (build_fused_ce(weights, ignore_background=True, device="cpu")
          if loss == "fused" else
          build_loss("wCEL", weights=weights, ignore_background=True,
                     device="cpu"))
    image, mask = torch.from_numpy(image), torch.from_numpy(mask)
    if m is not None:
        image, mask = mesh_lib.shard_rows(
            mesh_lib.shard_batch((image, mask), m), m)
    halo.reset_gathered()
    got = train_step(state, fn, image, mask, mesh=m, rows=m is not None)
    return float(got), dp_state(model), halo.gathered()


def halo_checks(rank, m, cases):
    """Each ``cases`` entry (name -> (whole f64 map, upstream gradients
    per rank, tops, bots, ring)): this rank's strip through ``row_halo``
    and the gradient that comes back to it; ``"gather"``: the whole map
    from ``gather_rows``, and the strip's gradient of a per-rank
    objective on it."""
    from cvcs_tpu_torch.parallel import halo

    n = m.shape["spatial"]
    out = {}
    for name, (whole, grads, tops, bots, ring) in cases.items():
        h = whole.shape[1] // n
        x = torch.from_numpy(whole[:, rank * h:(rank + 1) * h].copy())
        x.requires_grad_(True)
        if name == "gather":
            y = halo.gather_rows(x, m)
        else:
            y = halo.row_halo(x, m, tops, bots, ring=ring)
        (y * torch.from_numpy(grads[rank])).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def train_cli_run(cfg) -> dict:
    """``cli.train`` on ``cfg`` for its epochs, then a resume for one more
    with ``load_checkpoint: auto``: the losses, the last evaluation's
    confusion matrix and a digest of the final state."""
    from cvcs_tpu_torch.cli import train as train_cli

    first = train_cli.build_trainer(cfg)
    first.train()
    resumed = train_cli.build_trainer(dict(cfg, epochs=cfg["epochs"] + 1,
                                           load_checkpoint="auto"))
    resumed.train()
    return dict(train=first.training_loss_values,
                val=first.validation_loss_values,
                resumed_from=resumed.last_epoch,
                resumed_train=resumed.training_loss_values,
                confusion=np.asarray(resumed.conf_history[-1]).tolist(),
                digest=digest(dp_state(resumed.state.model)))


def spatial_body(rank, world, data, steps, halos, cli, single=None):
    """The ``steps`` (name -> (net, start path, image, mask, loss,
    weights, keep)) on a (data x world / data) mesh, row strips over its
    spatial axis; rank 0 returns the states, every rank its losses, a
    digest of its states and the ops that took the gather. ``halos``: the
    :func:`halo_checks` cases (a spatial-only mesh). ``cli``: (config,
    or None) :func:`train_cli_run` with ``mesh: {spatial: world}``;
    ``single``: (config, or None) the same without a mesh, on rank 0
    afterwards (the one-process reference)."""
    m = mesh(data=data, spatial=world // data)
    out = {}
    for name, (net, path, image, mask, loss, weights, keep) in \
            steps.items():
        value, state, gathered = spatial_step(net, path, image, mask, loss,
                                              weights, keep, m)
        out[name] = (value, state if rank == 0 else None, digest(state),
                     gathered)
    if halos:
        from cvcs_tpu_torch.parallel.halo import exchange_row_halo

        out["halo"] = halo_checks(rank, m, halos)
        # the inference halo wider than a strip: 6 rows over strips of 4
        whole = halos["conv"][0][0]
        h = whole.shape[0] // world
        out["wide"] = exchange_row_halo(
            torch.from_numpy(whole[rank * h:(rank + 1) * h].copy()), 6,
            m).numpy()
    if cli is not None:
        out["cli"] = train_cli_run(dict(cli, mesh={"spatial": world}))
    if single is not None and rank == 0:
        out["single"] = train_cli_run(single)
    return out


# -- test_torch_tp -------------------------------------------------------------
class ComputeWidths(torch.overrides.TorchFunctionMode):
    """Records the output channels every conv and linear call writes,
    by the identity of its weight (a hook on torch's functions: the
    models call ``F.conv2d`` / ``F.linear`` on their holders' weights)."""

    def __init__(self):
        super().__init__()
        self.widths = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        F = torch.nn.functional
        if func in (F.conv2d, F.linear, F.conv_transpose2d):
            w = args[1] if len(args) > 1 else kwargs["weight"]
            c = out.shape[1] if func is not F.linear else out.shape[-1]
            self.widths.setdefault(w.untyped_storage().data_ptr(),
                                   set()).add(int(c))
        return out


def tp_body(rank, world, cases, min_channels):
    """Each of ``cases`` (name -> (net, state dict path, image)): the f32
    eval forward under ``shard_params`` and ``tensor_parallel`` over the
    mesh's spatial axis. Returns (logits, {weight name: (whole bytes,
    this rank's bytes)} for the sharded kernels, {holder name: (full
    output channels, widths written)} for every conv/linear that ran,
    and on rank 0 the replicated forward's logits)."""
    from cvcs_tpu_torch.models.registry import MODEL_REGISTRY
    from cvcs_tpu_torch.parallel import tp

    m = mesh(data=1, spatial=world)
    out = {}
    for name, (net, path, image) in cases.items():
        model = MODEL_REGISTRY[net].build(NC, dtype=torch.float32)
        model.load_state_dict(torch.load(path, weights_only=True),
                              strict=True)
        model.eval()
        base = None
        if rank == 0:
            with torch.no_grad():
                base = model(torch.from_numpy(image)).numpy()
        whole = {k: v.numel() * v.element_size()
                 for k, v in model.named_parameters()}
        full = {n: h.weight.shape[1 if isinstance(
            h, torch.nn.ConvTranspose2d) else 0]
                for n, h in model.named_modules()
                if isinstance(h, (torch.nn.Conv2d, torch.nn.Linear,
                                  torch.nn.ConvTranspose2d))}
        rule = tp.channel_shardings(model, m, min_channels=min_channels)
        tp.shard_params(model, m, min_channels=min_channels)
        params = dict(model.named_parameters())
        sharded = {k: (whole[k], params[k].numel() * params[k].element_size())
                   for k, dim in rule.items() if dim is not None}
        rec = ComputeWidths()
        with torch.no_grad(), rec, tp.tensor_parallel(
                m, min_channels=min_channels):
            logits = model(torch.from_numpy(image))
        writes = {}
        for n, h in model.named_modules():
            ptr = getattr(getattr(h, "weight", None), "untyped_storage",
                          None)
            if n in full and ptr is not None:
                got = rec.widths.get(h.weight.untyped_storage().data_ptr())
                if got:
                    writes[n] = (full[n], sorted(got))
        out[name] = (logits.numpy(), sharded, writes, base)
    return out
