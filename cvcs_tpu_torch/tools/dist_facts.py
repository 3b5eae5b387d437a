"""Which ``torch.distributed`` backends a host with one card offers the
mesh, case by case: NCCL with two ranks on one GPU and with one; gloo's
collectives and point-to-point sends on CUDA tensors; gloo's sends on CPU
tensors.

    python -m cvcs_tpu_torch.tools.dist_facts

Each case runs its ranks as processes of their own, all on ``cuda:0``,
over a ``file://`` rendezvous, and prints each rank's JSON line (``ok``,
the result or the error); a case that does not end in 60 s is killed and
printed as ``TIMEOUT``. ``chip_smoke.py`` phase 9 and
``cvcs_tpu_torch/parallel/halo.py`` are built on what it finds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

CASES = ("nccl_two_ranks", "nccl_one_rank", "gloo_cuda_allreduce",
         "gloo_cuda_sendrecv", "gloo_cuda_batch_isend", "gloo_cuda_allgather",
         "gloo_cuda_broadcast", "gloo_cuda_nn_allreduce", "gloo_cpu_sendrecv")


def _case(case: str, rank: int, dev):
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device=dev)
    if case.startswith("nccl") or case == "gloo_cuda_allreduce":
        dist.all_reduce(t)
        return t.tolist()
    if case == "gloo_cuda_sendrecv":
        if rank == 0:
            dist.send(t, 1)
            return None
        r = torch.zeros(4, device=dev)
        dist.recv(r, 0)
        return r.tolist()
    if case in ("gloo_cuda_batch_isend", "gloo_cpu_sendrecv"):
        if case == "gloo_cpu_sendrecv":
            t = t.cpu()
        r = torch.zeros_like(t)
        ops = [dist.P2POp(dist.isend, t, 1 - rank),
               dist.P2POp(dist.irecv, r, 1 - rank)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return r.tolist()
    if case == "gloo_cuda_allgather":
        parts = [torch.zeros(4, device=dev) for _ in range(world)]
        dist.all_gather(parts, t)
        return [p.tolist() for p in parts]
    if case == "gloo_cuda_broadcast":
        dist.broadcast(t, 0)
        return t.tolist()
    if case == "gloo_cuda_nn_allreduce":
        import torch.distributed.nn.functional as dfn

        x = torch.ones(4, device=dev, requires_grad=True)
        y = dfn.all_reduce(x)
        y.sum().backward()
        return dict(sum=y.tolist(), grad=x.grad.tolist())
    raise ValueError(case)


def rank_main(case: str, rank: int, world: int, init: str) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl" if case.startswith("nccl") else "gloo",
                            init_method=init, rank=rank, world_size=world)
    out = dict(case=case, rank=rank)
    try:
        out.update(ok=True, result=_case(case, rank, torch.device("cuda:0")))
        torch.cuda.synchronize()
    except Exception as err:   # the fact wanted is this error
        out.update(ok=False, error=f"{type(err).__name__}: {str(err)[:600]}")
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    import torch

    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), "NCCL",
          torch.cuda.nccl.version(), flush=True)
    for case in CASES:
        world = 1 if case == "nccl_one_rank" else 2
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            procs = [subprocess.Popen(
                [sys.executable, "-m", __spec__.name, "--rank", case,
                 str(r), str(world), f"file://{tmp}/rdv"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
            for p in procs:
                try:
                    text, _ = p.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
                    print(case, "TIMEOUT", flush=True)
                    continue
                lines = [ln for ln in text.splitlines() if ln.startswith("{")]
                print(case, "rc", p.returncode,
                      *(lines or [text[-1500:]]), flush=True)
            print(case, f"{time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5])
        sys.exit(0)
    sys.exit(main())
