"""Row halo exchange between spatial neighbours (port of
``cvcs_tpu/parallel/halo.py``).

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
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from cvcs_tpu_torch.core.mesh import SPATIAL_AXIS, Mesh


def _staged(x: torch.Tensor, group) -> bool:
    """Whether CUDA rows go through host buffers on this group."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def exchange_row_halo(x: torch.Tensor, halo: int, mesh: Mesh,
                      axis: int = 0) -> torch.Tensor:
    """This rank's row strip ``x`` extended by ``halo`` rows from each
    spatial neighbour along ``axis`` (0: an (H_local, W, ...) strip; 1:
    a scene stack (S_local, H_local, W, ...)): [prev's bottom rows | x |
    next's top rows], zeros at the mesh's ends, and the zero pad alone
    when the spatial axis has one rank or ``halo`` is 0."""
    n = mesh.shape[SPATIAL_AXIS]
    pad_shape = list(x.shape)
    pad_shape[axis] = halo
    from_prev = x.new_zeros(pad_shape)
    from_next = x.new_zeros(pad_shape)
    if n > 1 and halo:
        h = x.shape[axis]
        if halo > h:
            raise ValueError(f"halo {halo} exceeds the {h} local rows")
        s = mesh.spatial_index
        group = mesh.spatial_group
        staged = _staged(x, group)

        def wire(t):
            t = t.contiguous()
            if staged:
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t)
                return host
            return t

        top = wire(x.narrow(axis, 0, halo))
        bottom = wire(x.narrow(axis, h - halo, halo))
        recv_prev = wire(from_prev) if s > 0 else None
        recv_next = wire(from_next) if s < n - 1 else None
        ops = []
        if s > 0:
            prev = mesh.spatial_ranks[s - 1]
            ops += [dist.P2POp(dist.isend, top, prev, group),
                    dist.P2POp(dist.irecv, recv_prev, prev, group)]
        if s < n - 1:
            nxt = mesh.spatial_ranks[s + 1]
            ops += [dist.P2POp(dist.isend, bottom, nxt, group),
                    dist.P2POp(dist.irecv, recv_next, nxt, group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if recv_prev is not None:
            from_prev = recv_prev.to(x.device)
        if recv_next is not None:
            from_next = recv_next.to(x.device)
    return torch.cat([from_prev, x, from_next], dim=axis)


def sharded_rows(total_rows: int, axis_size: int) -> int:
    """Rows per rank; they must divide evenly (callers pad scenes to a
    multiple of ``patch_size * axis_size`` before sharding)."""
    if total_rows % axis_size:
        raise ValueError(
            f"{total_rows} rows do not shard evenly over {axis_size} devices")
    return total_rows // axis_size
