"""The (data, spatial) mesh of ranks on ``torch.distributed`` (port of
``cvcs_tpu/core/mesh.py``).

The JAX package is single-controller: one process drives every device
through ``shard_map`` and GSPMD. The port runs one process per device (a
rank), launched by ``torchrun`` or ``torch.multiprocessing``; the ranks
each run their own share and meet in collectives. The mesh lays the
ranks out row-major, as JAX's ``reshape(data, spatial)`` lays out its
devices: rank = d * spatial + s.

* The ``data`` axis: data parallelism. The ranks that share a spatial
  coordinate form a data group (a spatial column of the mesh); gradients,
  BatchNorm statistics and loss sums are reduced over it, and the
  scene-parallel inference spreads scenes over it.
* The ``spatial`` axis: the row-sharded scene paths. The ranks that share
  a data coordinate form a spatial group (a data row of the mesh) and
  exchange halo rows within it (:mod:`cvcs_tpu_torch.parallel.halo`).

Every rank creates every group, in the same order. When no default group
exists, :func:`create_mesh` initialises one from ``torchrun``'s
environment (``env://``) with the backend that follows the device: NCCL
for ``cuda``, gloo for the CPU. A caller that initialised the default
group itself keeps its backend: two ranks that share one card must use
gloo, since NCCL refuses two ranks on one GPU ("Duplicate GPU detected").
A single process with no group and no ``torchrun`` environment is a world
of one: its groups are None and the collectives are identities.

``batch_sharding`` (a ``NamedSharding``) has no counterpart: a rank holds
its share of a batch as a plain tensor, cut by :func:`shard_batch`.

While :func:`data_parallel` is active, the train-mode BatchNorm statistics
(``models/blocks.py``), the losses (``ops/losses.py``,
``ops/fused_ce.py``) and the seeded dropout reduce or draw over the active
mesh's data group, so that a step on each rank's share equals the step on
the global batch.

While :func:`spatial_parallel` is active, each rank's share is also cut
to its strip of rows (:func:`shard_rows`, JAX's ``_shard`` putting patch
rows over the ``spatial`` axis), and the maps of the forward are row
strips: the convolutions, resizes and window attentions exchange halo
rows with their spatial neighbours (``parallel/halo.py``), and the sums
above span the whole (data x spatial) world. A map whose rows do not
split evenly over the spatial group is gathered whole on every rank
(``halo.gather_rows``); the code that computes on it runs inside
:func:`whole_rows`, where the sums span the data group only (every
spatial rank holds the same whole map) and no halo is taken.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any

import torch
import torch.distributed as dist

from cvcs_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
SPATIAL_AXIS = "spatial"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How to lay the ranks out. ``data * spatial`` must equal the number
    of ranks; ``data=None`` means every rank the spatial axis leaves."""

    data: int | None = None
    spatial: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int]:
        spatial = self.spatial
        data = self.data if self.data is not None else n_devices // spatial
        if data * spatial != n_devices:
            raise ValueError(
                f"mesh {data}x{spatial} does not cover {n_devices} devices"
            )
        return data, spatial


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the (data, spatial) layout: its coordinates,
    the global ranks and process group of its data group (same spatial
    coordinate) and of its spatial group (same data coordinate), and its
    device. ``shape`` maps each axis name to its size, as a JAX mesh's."""

    shape: dict
    rank: int
    data_index: int
    spatial_index: int
    data_ranks: tuple
    spatial_ranks: tuple
    data_group: Any
    spatial_group: Any
    device: torch.device
    world_group: Any = None

    @property
    def size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[SPATIAL_AXIS]


def world() -> tuple[int, int]:
    """(rank, world size) of the default group, or of ``torchrun``'s
    environment before the group exists, or (0, 1)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return (int(os.environ.get("RANK", 0)),
            int(os.environ.get("WORLD_SIZE", 1)))


def mesh_device(device=None) -> torch.device:
    """The rank's device: the CPU when asked for, else
    ``cuda:LOCAL_RANK`` (raises when there is no card)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    dev = resolve_device(device)
    if dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def create_mesh(config: MeshConfig | None = None, device=None) -> Mesh:
    """The (data, spatial) mesh over every rank of the default group,
    initialising the group from ``torchrun``'s environment when none
    exists and the environment names more than one rank (NCCL for a
    ``cuda`` device, gloo for the CPU)."""
    config = config or MeshConfig()
    dev = mesh_device(device)
    rank, size = world()
    data, spatial = config.resolve(size)
    if not dist.is_initialized() and size > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://", rank=rank,
                                world_size=size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    d, s = divmod(rank, spatial)
    data_ranks = tuple(i * spatial + s for i in range(data))
    spatial_ranks = tuple(d * spatial + j for j in range(spatial))
    data_group = spatial_group = None
    if dist.is_initialized():
        # every rank creates every group, in the same order
        for j in range(spatial):
            g = dist.new_group([i * spatial + j for i in range(data)])
            if j == s:
                data_group = g
        for i in range(data):
            g = dist.new_group([i * spatial + j for j in range(spatial)])
            if i == d:
                spatial_group = g
    return Mesh({DATA_AXIS: data, SPATIAL_AXIS: spatial}, rank, d, s,
                data_ranks, spatial_ranks, data_group, spatial_group, dev,
                dist.group.WORLD if dist.is_initialized() else None)


def local_mesh(device=None) -> Mesh:
    """A 1x1 mesh of this process alone (no group): the single-device
    layout."""
    return Mesh({DATA_AXIS: 1, SPATIAL_AXIS: 1}, 0, 0, 0, (0,), (0,),
                None, None, mesh_device(device))


# -- collectives -----------------------------------------------------------
def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` itself when
    the group is None). gloo takes CUDA tensors for its collectives."""
    if group is None:
        return t
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, whose backward sums the upstream gradients over
    the group (each rank's objective is its term of one total)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


class _AllReduceSumOwnGrad(torch.autograd.Function):
    """Sum over the group whose backward passes the gradient through to
    this rank's term alone: for a value that every rank computes alike
    (a loss over the global batch), whose gradient each rank takes only
    through its own share of the batch."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in the
    group's rank order."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from rank 0, so
    that every rank starts from one state."""
    if mesh is not None and dist.is_initialized() and mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module


def broadcast_object(obj, mesh: Mesh | None):
    """Rank 0's ``obj`` on every rank of the mesh."""
    if mesh is None or not dist.is_initialized() or mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0,
                               device=mesh.device
                               if dist.get_backend() == "nccl" else None)
    return box[0]


def every_rank(flags: list, mesh: Mesh | None) -> list:
    """Each of ``flags`` and-ed over the ranks of the mesh: every rank
    gets the same answer, so that they take the same branch."""
    if (mesh is None or not dist.is_initialized() or mesh.size == 1
            or not flags):
        return list(flags)
    t = torch.tensor([1.0 if f else 0.0 for f in flags], device=mesh.device)
    dist.all_reduce(t)
    return [bool(v == mesh.size) for v in t.tolist()]


def any_rank(flag: bool, mesh: Mesh | None) -> bool:
    """Whether ``flag`` is set on any rank of the mesh."""
    return not every_rank([not flag], mesh)[0]


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None and dist.is_initialized() and mesh.size > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[mesh.device.index])
        else:
            dist.barrier()


# -- data parallelism --------------------------------------------------------
def data_slice(n: int, mesh: Mesh, micro: int = 1) -> torch.Tensor | None:
    """Indices of this rank's samples of a leading dimension of ``n``, or
    None when they do not split evenly (the leaf is then kept whole, as
    JAX replicates it). With ``micro = A`` the dimension is A
    micro-batches of n / A global samples each, and the rank takes its
    contiguous slice of each, in order: micro-batch k of the rank's share
    is its slice of the global samples [k n / A, (k + 1) n / A)."""
    d = mesh.shape[DATA_AXIS]
    if n % micro or (n // micro) % d:
        return None
    m, b = n // micro, n // micro // d
    lo = mesh.data_index * b
    return torch.cat([torch.arange(k * m + lo, k * m + lo + b)
                      for k in range(micro)])


def shard_batch(batch, mesh: Mesh, micro: int = 1):
    """This rank's share of a batch (a tensor, or a tuple, list or dict
    of tensors and Nones): the rank's slice of each leaf's leading
    dimension (:func:`data_slice`), or the whole leaf where it does not
    divide."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, micro) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh, micro) for v in batch)
    if batch is None or batch.dim() == 0:
        return batch
    idx = data_slice(batch.shape[0], mesh, micro)
    if idx is None:
        return batch
    if micro == 1:
        return batch[idx[0]:idx[-1] + 1]
    return batch[idx.to(batch.device)]


def shard_rows(batch, mesh: Mesh):
    """This rank's strip of rows of a batch (a tensor, or a tuple, list or
    dict of tensors and Nones): rows [s h, (s + 1) h) of the second axis
    of every leaf with at least three axes (an NHWC image, a (B, H, W)
    mask), h = H / spatial; lower-rank leaves (valid flags) stay whole.
    Call it only when :func:`rows_divide` holds for the batch's rows."""
    if isinstance(batch, dict):
        return {k: shard_rows(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_rows(v, mesh) for v in batch)
    if batch is None or batch.dim() < 3:
        return batch
    n = mesh.shape[SPATIAL_AXIS]
    h = batch.shape[1] // n
    return batch[:, mesh.spatial_index * h:(mesh.spatial_index + 1) * h]


def rows_divide(rows: int, mesh: Mesh | None) -> bool:
    """Whether ``rows`` patch rows split over the mesh's spatial axis (of
    more than one rank): JAX's ``_shard`` shards them only then."""
    return (mesh is not None and mesh.shape[SPATIAL_AXIS] > 1
            and rows % mesh.shape[SPATIAL_AXIS] == 0)


_ACTIVE: Mesh | None = None      # the mesh whose sums span the global batch
_STRIPS = False                  # the maps are row strips over its spatial axis
_WHOLE = False                   # ... but the code now runs on whole maps


def strip_mesh() -> Mesh | None:
    """The mesh whose spatial group holds the current maps' row strips:
    set under :func:`spatial_parallel`, None inside :func:`whole_rows` and
    outside."""
    return _ACTIVE if _STRIPS and not _WHOLE else None


@contextlib.contextmanager
def _active(mesh: Mesh | None, strips: bool):
    global _ACTIVE, _STRIPS, _WHOLE
    prev = _ACTIVE, _STRIPS, _WHOLE
    _ACTIVE, _STRIPS, _WHOLE = mesh, strips, False
    try:
        yield mesh
    finally:
        _ACTIVE, _STRIPS, _WHOLE = prev


def data_parallel(mesh: Mesh | None):
    """Within the block, BatchNorm statistics, losses and the seeded
    dropout work on this rank's share of a global batch split over the
    mesh's data group. A mesh whose data axis has one rank is no data
    parallelism."""
    on = mesh is not None and mesh.shape[DATA_AXIS] > 1
    return _active(mesh if on else None, False)


def spatial_parallel(mesh: Mesh | None):
    """:func:`data_parallel`, and the maps are row strips over the mesh's
    spatial group: the rank's share is its data slice cut to its strip of
    rows (:func:`shard_rows`), the models' convolutions, resizes and
    window attentions take halo rows from the neighbours, and the sums
    span every rank of the mesh. A mesh whose spatial axis has one rank
    is :func:`data_parallel`."""
    if mesh is None or mesh.shape[SPATIAL_AXIS] == 1:
        return data_parallel(mesh)
    return _active(mesh, True)


@contextlib.contextmanager
def whole_rows(whole: bool = True):
    """Within the block (when ``whole``), the maps are whole on every
    spatial rank: no halo is taken, and the sums span the data group
    only. Model code enters it where it has gathered a map whose rows do
    not split over the spatial group."""
    global _WHOLE
    prev = _WHOLE
    _WHOLE = _WHOLE or whole
    try:
        yield
    finally:
        _WHOLE = prev


def mesh_state() -> tuple:
    """The parallel contexts as they stand, for :func:`restore_state` in
    code that runs again outside them (a rematerialised block)."""
    return _ACTIVE, _STRIPS, _WHOLE


@contextlib.contextmanager
def restore_state(state: tuple):
    global _ACTIVE, _STRIPS, _WHOLE
    prev = _ACTIVE, _STRIPS, _WHOLE
    _ACTIVE, _STRIPS, _WHOLE = state
    try:
        yield
    finally:
        _ACTIVE, _STRIPS, _WHOLE = prev


def _sum_group():
    """(group, ranks) the current sums span: the world under row strips,
    else the data group; (None, 1) when there is nothing to reduce."""
    mesh = _ACTIVE
    if mesh is None:
        return None, 1
    if _STRIPS and not _WHOLE:
        return mesh.world_group, mesh.size
    if mesh.shape[DATA_AXIS] == 1:
        return None, 1
    return mesh.data_group, mesh.shape[DATA_AXIS]


def dp_sum(t: torch.Tensor, own_grad: bool = False) -> torch.Tensor:
    """``t`` summed over the ranks that share the global batch,
    differentiably (``t`` itself outside :func:`data_parallel` and
    :func:`spatial_parallel`): the data group, or under row strips every
    rank. The backward sums the upstream gradients over the group
    (BatchNorm's statistics feed every rank's share of the total), or
    with ``own_grad`` passes them to this rank's term alone (a loss that
    every rank computes over the global batch)."""
    group, n = _sum_group()
    if n == 1:
        return t
    fn = _AllReduceSumOwnGrad if own_grad else _AllReduceSum
    return fn.apply(t, group)


def sum_group():
    """The process group of :func:`dp_sum` (None: nothing to reduce)."""
    return _sum_group()[0]


def dp_size() -> int:
    """How many equal shares the global batch's sums span (the data
    group's ranks, times the spatial ranks under row strips)."""
    return _sum_group()[1]


def dp_index() -> int:
    """This rank's data coordinate under :func:`data_parallel` or
    :func:`spatial_parallel` (0 outside)."""
    mesh = _ACTIVE
    return 0 if mesh is None or mesh.shape[DATA_AXIS] == 1 else mesh.data_index


def data_ranks() -> int:
    """The data group's ranks under either context (1 outside)."""
    return 1 if _ACTIVE is None else _ACTIVE.shape[DATA_AXIS]


def reduce_grads(params, mesh: Mesh, average: bool = False,
                 spatial: bool = False) -> None:
    """Sum (or average) the gradients of ``params`` over the mesh's data
    group in one flat all-reduce, or with ``spatial`` (a step on row
    strips) over every rank of the mesh. Every parameter must hold a
    gradient (``train.step.zero_unused_grads`` runs first), so the flat
    layout is the same on every rank."""
    if mesh is None:
        return
    group, n = ((mesh.world_group, mesh.size) if spatial
                else (mesh.data_group, mesh.shape[DATA_AXIS]))
    if n == 1:
        return
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    dist.all_reduce(flat, group=group)
    if average:
        flat /= n
    off = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[off:off + n].view_as(g))
        off += n
