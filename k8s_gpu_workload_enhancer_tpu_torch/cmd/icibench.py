"""Collective microbenchmark: the bandwidth of a gang's all-reduce,
all-gather and neighbour ring shift.

Port of k8s_gpu_workload_enhancer_tpu/cmd/icibench.py (its JSON keys and
its algorithmic bandwidth factors). It times, over the gang that
`train/bootstrap.initialize` starts from the launcher env (NCCL on the
card, gloo with --device cpu), an all-reduce, an all-gather and a shift of
every rank's block to the next rank (`batch_isend_irecv`), each of --mb
MB of bf16 a rank, through the port's collectives (parallel/comm.py), and
reports the algorithmic bandwidth a rank: a ring all-reduce moves 2(n-1)/n
bytes a byte reduced, an all-gather (n-1)/n, the shift 1; at one rank
each is 0.0. A process that is no gang's member runs the single-rank
sanity case over a group of one on localhost (the card's NCCL, or gloo);
there the shift is the identity, timed as the block's copy. --axis names
the mesh axis to bench; where that axis has one rank, every rank is folded
onto one group, as the JAX bench folds its devices. Only the primary rank
prints, one JSON line:

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.icibench --mb 256
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel import comm
from ..train import bootstrap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, device: torch.device, iters: int = 10,
            warmup: int = 2) -> float:
    """Seconds a call of `fn`, the mean of `iters` after `warmup`."""
    for _ in range(warmup):
        fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters


def bench_collectives(group, mbytes: int, device: torch.device,
                      iters: int = 10) -> dict:
    """ms and algorithmic GB/s a rank of the three collectives over
    `group` (None: the whole gang) of --mb MB of bf16 a rank."""
    n = dist.get_world_size(group)
    per_rank = mbytes * 1024 * 1024 // 2          # bf16 elements
    x = torch.ones(per_rank, dtype=torch.bfloat16, device=device)
    acc = x.clone()
    gathered = torch.empty(n * per_rank, dtype=x.dtype, device=device)
    r = dist.get_rank(group)
    world = group or dist.group.WORLD
    nxt = dist.get_global_rank(world, (r + 1) % n)
    prv = dist.get_global_rank(world, (r - 1) % n)

    def shift():
        if n == 1:
            return x.clone()
        return comm.exchange(x, nxt, prv, group)

    nbytes = per_rank * 2
    out = {}
    t = _timeit(lambda: comm.all_reduce(acc, group), device, iters)
    out["allreduce_ms"] = round(t * 1e3, 3)
    out["allreduce_gbps_per_chip"] = round(
        2.0 * (n - 1) / n * nbytes / t / 1e9, 2) if n > 1 else 0.0
    t = _timeit(lambda: comm.all_gather_into(gathered, x, group), device,
                iters)
    out["allgather_ms"] = round(t * 1e3, 3)
    out["allgather_gbps_per_chip"] = round(
        (n - 1) / n * nbytes / t / 1e9, 2) if n > 1 else 0.0
    t = _timeit(shift, device, iters)
    out["ppermute_ms"] = round(t * 1e3, 3)
    out["ppermute_gbps_per_chip"] = round(nbytes / t / 1e9, 2) \
        if n > 1 else 0.0
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None, env: Optional[dict] = None) -> int:
    p = argparse.ArgumentParser(prog="ktwe-icibench")
    p.add_argument("--mb", type=int, default=256,
                   help="payload megabytes per chip")
    p.add_argument("--axis", type=str, default="dp")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the card over NCCL (default), or the CPU over "
                        "gloo")
    args = p.parse_args(argv)
    env = dict(os.environ if env is None else env)
    if int(env.get("NUM_PROCESSES", "1")) <= 1 and \
            not env.get("COORDINATOR_ADDRESS"):
        env["COORDINATOR_ADDRESS"] = f"localhost:{_free_port()}"
    ctx = bootstrap.initialize(env, device=args.device, group_of_one=True)
    try:
        mesh, axis = ctx.mesh, args.axis
        group = (mesh.get_group(axis) if mesh[axis].size() > 1
                 else None)                 # every rank on one group
        result = {
            "devices": dist.get_world_size(),
            "axis_size": dist.get_world_size(group),
            "payload_mb_per_chip": args.mb,
            **bench_collectives(group, args.mb, ctx.device),
        }
        if ctx.is_primary:
            print(json.dumps(result), flush=True)
    finally:
        ctx.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
