"""Which ``gloo`` collectives take CUDA tensors as they are, on this
machine's torch: for each operation a fresh group of two processes on one
card tries it once on a CUDA tensor (an operation that cannot may end the
process from C++, so each runs alone). The port's mesh does not depend on
the answer: with ``gloo`` and a CUDA device it stages every collective
through host memory (``parallel/mesh.py``, ``Mesh.transport == "host"``).

    python3 tools/probe_gloo_cuda.py

prints one line per operation: its result, the Python error's first line,
or the exit codes of a group that died.
"""
from __future__ import annotations

import multiprocessing
import socket
import sys

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "send_recv")


def _run(op: str, dist, torch, rank: int):
    x = torch.full((4,), float(rank + 1), device="cuda")
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        return y
    if op == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        return y
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)
    if op == "all_gather_into_tensor":
        out = torch.empty(8, device="cuda")
        dist.all_gather_into_tensor(out, x)
        return out
    buf = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, 1 - rank), dist.P2POp(dist.irecv, buf, 1 - rank)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def _worker(op: str, rank: int, port: int, queue) -> None:
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        result = f"ok {_run(op, dist, torch, rank).tolist()}"
    except Exception as err:  # the probe reports every Python-level failure
        result = f"raises: {str(err).splitlines()[0]}"
    if rank == 0:
        queue.put(result)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: no CUDA device")
        return 1
    print(f"torch {torch.__version__}, {torch.cuda.get_device_name(0)}")
    ctx = multiprocessing.get_context("spawn")
    for op in OPS:
        queue = ctx.Queue()
        port = _free_port()
        procs = [ctx.Process(target=_worker, args=(op, r, port, queue)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(120)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        codes = [p.exitcode for p in procs]
        result = queue.get(timeout=5) if not queue.empty() else "no result"
        print(f"gloo {op} on CUDA tensors: {result}; exit codes {codes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
