"""Row halo exchange between spatial neighbours (port of
``cvcs_tpu/parallel/halo.py``), and the differentiable row collectives of
spatially partitioned training.

When a scene's row strips are spread over the mesh's ``spatial`` axis,
each rank needs ``halo`` rows of its neighbours so that the
border-corrected windows at its strip's edges see real pixels instead of
padding. JAX does it with one ``ppermute`` down and one up; here it is
one send each way between neighbouring ranks of the spatial group
(``dist.batch_isend_irecv``). The ranks at the mesh's ends receive zeros,
the padding the single-device path uses at the scene's borders.

gloo's point-to-point sends take no CUDA tensor (its TCP transport reads
the pointer as host memory: "writev ... Bad address" on the card host),
while its collectives do. So on a gloo group the exchange stages CUDA
rows through pinned host buffers; on NCCL, and for CPU tensors, the rows
go as they are. That is a branch on the group's backend, not a
fallback.

Training on row strips (``core/mesh.py`` ``spatial_parallel``) needs the
same exchange under autograd, which JAX's GSPMD partitioner inserted
for it. :func:`row_halo` is a ``torch.autograd.Function``: its forward
takes ``tops[s]`` rows from the previous rank and ``bots[s]`` from the
next (counts that may differ from rank to rank, as a shifted window's
do), and its backward sends each halo row's gradient back to the rank
that owns the row, which adds it to its own. With ``ring`` the last
rank's next is rank 0 and rank 0's previous the last rank (Swin's cyclic
roll); otherwise the ends receive zeros. :func:`gather_rows` all-gathers
a strip into the whole map (its backward sums every rank's gradient and
keeps the rank's own rows) and :func:`split_rows` keeps the rank's own
rows of a whole map (its backward zero-pads). A map whose halo would be
wider than a neighbour's strip, or whose rows do not split, takes the
gather: :func:`gathered` lists every op that did, with the reason.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from cvcs_tpu_torch.core.mesh import (SPATIAL_AXIS, Mesh, all_gather_cat,
                                      all_reduce_sum)

_DOWN, _UP = 1, 2      # tags: a strip's last rows to the next rank; first to the previous


def _staged(x: torch.Tensor, group) -> bool:
    """Whether CUDA rows go through host buffers on this group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def exchange_row_halo(x: torch.Tensor, halo: int, mesh: Mesh,
                      axis: int = 0) -> torch.Tensor:
    """This rank's row strip ``x`` extended by ``halo`` rows from each
    spatial neighbour along ``axis`` (0: an (H_local, W, ...) strip; 1:
    a scene stack (S_local, H_local, W, ...)): [prev's bottom rows | x |
    next's top rows], zeros at the mesh's ends, and the zero pad alone
    when the spatial axis has one rank or ``halo`` is 0. A halo wider
    than the local rows takes the gather: the rows come from the whole
    map, all-gathered in the spatial group."""
    n = mesh.shape[SPATIAL_AXIS]
    pad_shape = list(x.shape)
    pad_shape[axis] = halo
    from_prev = x.new_zeros(pad_shape)
    from_next = x.new_zeros(pad_shape)
    if n > 1 and halo:
        h = x.shape[axis]
        s = mesh.spatial_index
        if halo > h:
            _gathered.setdefault(
                f"halo of {halo} rows over strips of {h}",
                dict(why="halo wider than a strip", shape=[h * n]))
            whole = torch.cat([from_prev, all_gather_cat(
                x, mesh.spatial_group, dim=axis), from_next], dim=axis)
            return whole.narrow(axis, s * h, h + 2 * halo)
        got_prev, got_next = _swap(
            mesh, x.narrow(axis, h - halo, halo), x.narrow(axis, 0, halo),
            halo, halo, x, ring=False, axis=axis)
        from_prev = from_prev if got_prev is None else got_prev
        from_next = from_next if got_next is None else got_next
    return torch.cat([from_prev, x, from_next], dim=axis)


def sharded_rows(total_rows: int, axis_size: int) -> int:
    """Rows per rank; they must divide evenly (callers pad scenes to a
    multiple of ``patch_size * axis_size`` before sharding)."""
    if total_rows % axis_size:
        raise ValueError(
            f"{total_rows} rows do not shard evenly over {axis_size} devices")
    return total_rows // axis_size


# -- the differentiable row collectives of training on strips --------------
# Every exchange and gather of this process: its count, bytes and host
# seconds, and the ops that took the gather (``what`` -> reason).
stats = dict(exchanges=0, exchange_bytes=0, exchange_s=0.0,
             gathers=0, gather_bytes=0, gather_s=0.0)
_gathered: dict = {}


def reset_stats() -> None:
    for k in stats:
        stats[k] = 0.0 if k.endswith("_s") else 0


def gathered() -> dict:
    """The ops that took the gather in this process since
    :func:`reset_gathered`: ``what`` -> the reason and the gathered map's
    (rows, columns, channels)."""
    return dict(_gathered)


def reset_gathered() -> None:
    _gathered.clear()


def _swap(mesh: Mesh, to_next, to_prev, n_prev: int, n_next: int,
          like: torch.Tensor, ring: bool, axis: int = 1):
    """One exchange in the spatial group: ``to_next`` (or None) to the
    next rank, ``to_prev`` to the previous; returns the ``n_prev`` rows
    the previous rank sent down and the ``n_next`` rows the next sent up
    (None for none, and from no rank past the mesh's ends unless
    ``ring``). Rows run along ``axis`` of ``like``'s shape."""
    n, s = mesh.shape[SPATIAL_AXIS], mesh.spatial_index
    prev = (s - 1) % n if ring or s > 0 else None
    nxt = (s + 1) % n if ring or s < n - 1 else None
    group = mesh.spatial_group
    staged = _staged(like, group)

    def wire(t):
        t = t.contiguous()
        if staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        return t

    def empty(rows):
        shape = list(like.shape)
        shape[axis] = rows
        return torch.empty(shape, dtype=like.dtype,
                           device="cpu" if staged else like.device,
                           pin_memory=staged)

    t0 = time.perf_counter()
    ops, sent = [], 0
    # the order (down, up, from the previous, from the next) matches the
    # k-th send from one rank to another with the k-th receive there, as
    # NCCL, which ignores tags, needs; gloo matches the tags
    if to_next is not None and to_next.shape[axis] and nxt is not None:
        ops.append(dist.P2POp(dist.isend, wire(to_next),
                              mesh.spatial_ranks[nxt], group, _DOWN))
        sent += to_next.numel() * to_next.element_size()
    if to_prev is not None and to_prev.shape[axis] and prev is not None:
        ops.append(dist.P2POp(dist.isend, wire(to_prev),
                              mesh.spatial_ranks[prev], group, _UP))
        sent += to_prev.numel() * to_prev.element_size()
    got_prev = empty(n_prev) if n_prev and prev is not None else None
    got_next = empty(n_next) if n_next and nxt is not None else None
    if got_prev is not None:
        ops.append(dist.P2POp(dist.irecv, got_prev, mesh.spatial_ranks[prev],
                              group, _DOWN))
    if got_next is not None:
        ops.append(dist.P2POp(dist.irecv, got_next, mesh.spatial_ranks[nxt],
                              group, _UP))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    stats["exchanges"] += 1
    stats["exchange_bytes"] += sent
    stats["exchange_s"] += time.perf_counter() - t0
    dev = like.device
    return (None if got_prev is None else got_prev.to(dev),
            None if got_next is None else got_next.to(dev))


class _RowHalo(torch.autograd.Function):
    """[tops[s] rows of the previous rank | x | bots[s] rows of the next]
    along axis 1, zeros where there is no neighbour; the backward returns
    each halo row's gradient to its owner, which adds it to its rows."""

    @staticmethod
    def forward(ctx, x, mesh, tops, bots, ring):
        n, s = mesh.shape[SPATIAL_AXIS], mesh.spatial_index
        h = x.shape[1]
        ctx.mesh, ctx.tops, ctx.bots, ctx.ring = mesh, tops, bots, ring
        down = tops[(s + 1) % n] if ring or s < n - 1 else 0
        up = bots[(s - 1) % n] if ring or s > 0 else 0
        from_prev, from_next = _swap(
            mesh, x.narrow(1, h - down, down), x.narrow(1, 0, up),
            tops[s], bots[s], x, ring)

        def zeros(rows):
            shape = list(x.shape)
            shape[1] = rows
            return x.new_zeros(shape)

        return torch.cat([zeros(tops[s]) if from_prev is None else from_prev,
                          x,
                          zeros(bots[s]) if from_next is None else from_next],
                         dim=1)

    @staticmethod
    def backward(ctx, g):
        mesh, tops, bots, ring = ctx.mesh, ctx.tops, ctx.bots, ctx.ring
        n, s = mesh.shape[SPATIAL_AXIS], mesh.spatial_index
        t, b = tops[s], bots[s]
        h = g.shape[1] - t - b
        down = tops[(s + 1) % n] if ring or s < n - 1 else 0
        up = bots[(s - 1) % n] if ring or s > 0 else 0
        # my bottom halo's gradient goes to the next rank (it is its first
        # rows), my top halo's to the previous; I get back the gradients
        # of the rows I sent
        from_prev, from_next = _swap(mesh, g.narrow(1, t + h, b),
                                     g.narrow(1, 0, t), up, down, g, ring)
        dx = g.narrow(1, t, h).clone()
        if from_prev is not None:
            dx.narrow(1, 0, up).add_(from_prev)
        if from_next is not None:
            dx.narrow(1, h - down, down).add_(from_next)
        return dx, None, None, None, None


def row_halo(x: torch.Tensor, mesh: Mesh, tops, bots,
             ring: bool = False) -> torch.Tensor:
    """This rank's strip ``x`` (rows along axis 1) extended by
    ``tops[s]`` rows of the previous rank above and ``bots[s]`` rows of
    the next below, differentiably. ``tops`` and ``bots`` hold every
    rank's counts (so a rank knows what its neighbours take from it); an
    int is the same count for every rank. With ``ring`` the ranks form a
    cycle; otherwise the mesh's ends receive zeros. Each count must not
    exceed the neighbour's rows (:func:`halo_fits`)."""
    n = mesh.shape[SPATIAL_AXIS]
    tops = (tops,) * n if isinstance(tops, int) else tuple(tops)
    bots = (bots,) * n if isinstance(bots, int) else tuple(bots)
    if n == 1 or not (any(tops) or any(bots)):
        return x
    return _RowHalo.apply(x, mesh, tops, bots, ring)


def halo_fits(rows, tops, bots, ring: bool = False) -> bool:
    """Whether every rank's halo comes from its immediate neighbours:
    ``rows[j]`` the rows rank j holds, ``tops[j]`` / ``bots[j]`` what it
    takes from its previous / next rank."""
    n = len(rows)
    for j in range(n):
        if (j > 0 or ring) and tops[j] > rows[(j - 1) % n]:
            return False
        if (j < n - 1 or ring) and bots[j] > rows[(j + 1) % n]:
            return False
    return True


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.h = mesh, x.shape[1]
        t0 = time.perf_counter()
        out = _all_gather_rows(x, mesh)
        stats["gathers"] += 1
        stats["gather_bytes"] += out.numel() * out.element_size()
        stats["gather_s"] += time.perf_counter() - t0
        return out

    @staticmethod
    def backward(ctx, g):
        # every rank's whole-map gradient, summed; this rank keeps its rows
        mesh, h = ctx.mesh, ctx.h
        total = all_reduce_sum(g.contiguous(), mesh.spatial_group)
        return total.narrow(1, mesh.spatial_index * h, h), None


def _all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.shape[SPATIAL_AXIS])]
    dist.all_gather(parts, x, group=mesh.spatial_group)
    return torch.cat(parts, dim=1)


def gather_rows(x: torch.Tensor, mesh: Mesh, what: str | None = None,
                why: str = "") -> torch.Tensor:
    """The whole map from every rank's strip of rows (axis 1), on every
    rank, differentiably; ``what`` names the op it serves in
    :func:`gathered` (with ``why``)."""
    if mesh.shape[SPATIAL_AXIS] == 1:
        return x
    out = _GatherRows.apply(x, mesh)
    if what is not None:
        _gathered.setdefault(what, dict(why=why, shape=list(out.shape[1:])))
    return out


def split_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's strip of a whole map's rows (axis 1), which must split
    evenly; the backward zero-pads the gradient to the whole map."""
    n = mesh.shape[SPATIAL_AXIS]
    h = sharded_rows(x.shape[1], n)
    return x[:, mesh.spatial_index * h:(mesh.spatial_index + 1) * h]
