"""Trainer main of the PyTorch port: KTWE-LM on one device or over a gang
of processes (FSDP over dp, pipeline parallelism over pp, expert
parallelism over ep, tensor parallelism over tp, sequence parallelism
over sp).

Port of k8s_gpu_workload_enhancer_tpu/cmd/trainer.py, with the same flags
and defaults (vocab 32768, d_model 2048, 8 layers, 16 heads, d_ff 8192,
seq 2048, batch 8) plus `--device` (cuda by default; raises without a
card) and `--seed`. It trains in bf16 on the card (f32 on the CPU), prints
a JSON line every 10 steps and a final summary line.

It starts with `train/bootstrap.initialize`, which reads the gang env the
controller's launcher injects (COORDINATOR_ADDRESS, NUM_PROCESSES,
PROCESS_ID, KTWE_MESH_AXES, KTWE_STRATEGY). In a gang each process is one
rank on one device and the ranks train one model on the mesh's dp, pp,
ep, tp and sp axes (train/trainer.py): the global batch is `--batch-size`,
each (dp, ep) batch coordinate takes its rows (the ranks of one
coordinate, its pp, tp and sp ranks, read the same rows, each sp rank its
shard of their positions), and only the primary
(PROCESS_ID 0) prints and writes checkpoints. Without the env, or at
NUM_PROCESSES 1, it trains on one device (`main(group_of_one=True)` runs
one process through the gang's FSDP step over a process group of one
instead, a check of that path on a single card).

- `--data-file` trains on a KTWE token shard (train/data.py, the JAX
  package's format and windows), else on seeded synthetic LM data.
- `--checkpoint-dir` saves the TrainState there (train/checkpoint.py)
  every `--checkpoint-every` steps in the background and at `--steps`;
  with `--resume` (or KTWE_RESUME=1) the latest step found is restored
  first (`resumed from step N`) and training goes on to `--steps`. The
  token stream resumes at the restored step; the synthetic stream
  restarts, as in the JAX trainer.
- SIGTERM finishes the step in flight, saves it (waiting for the file),
  writes the drain marker `drain-complete.json` beside it and prints a
  `drained` line. In a gang the ranks agree on the step: each step ends
  in a MAX all-reduce of the drain flag, so a signal to any rank drains
  every rank after the same step.
- `--n-experts N` trains the MoE model (every layer's FFN a router and N
  experts, top-1, through the sort-based capacity-bounded dispatch on one
  device, the dense one-hot route on a mesh of more; on an ep mesh each
  ep rank holds N/ep experts), as the JAX trainer builds it; its step
  lines and final line also carry the last step's MoE load-balance loss
  `aux`.

- A mesh with pp above 1 trains the layer-stack form of pipeline
  parallelism (each stage holds L/pp layers; every layer is broadcast from
  its stage when the forward reaches it, parallel/sharding.py).
  `--pipeline-microbatches M` trains through the explicit GPipe schedule
  instead (parallel/pipeline.gpipe_lm_loss, M microbatches, activations
  handed from stage to stage), the rows of each microbatch split over the
  schedule's batch axes (JAX's three cases: dp and ep, dp, or none). As
  in the JAX trainer it needs a pp axis above 1 and a `--batch-size`
  divisible by M, else it exits with JAX's message. With tp or sp above 1
  the stage runs whole on every tp and sp rank, as JAX's schedule does
  (the embedding, head and CE vocab-parallel over tp).

`--profile-dir` is accepted and unused, as in the JAX trainer.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer --steps 20
    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer --device cpu \
        --steps 10 --batch-size 2 --seq-len 32 --d-model 64 --n-layers 2 \
        --n-heads 2 --d-ff 128 --vocab-size 256 --checkpoint-dir ckpt
    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer --device cpu \
        --steps 2 --batch-size 2 --seq-len 32 --d-model 64 --n-layers 2 \
        --n-heads 2 --d-ff 128 --vocab-size 256 --n-experts 4

A gang of two CPU ranks (run both, PROCESS_ID 0 and 1):

    COORDINATOR_ADDRESS=localhost:29500 NUM_PROCESSES=2 PROCESS_ID=0 \
    KTWE_STRATEGY=FSDP python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer \
        --device cpu --steps 10 --batch-size 4 --seq-len 32 --d-model 64 \
        --n-layers 2 --n-heads 2 --d-ff 128 --vocab-size 256

A gang of eight on dp=2, tp=2, sp=2: the same with NUM_PROCESSES=8,
PROCESS_ID 0..7 and KTWE_MESH_AXES=dp=2,tp=2,sp=2 (or KTWE_STRATEGY=Hybrid,
which factors 8 processes so). MoE over four ranks on dp=2, ep=2: the same
with NUM_PROCESSES=4, KTWE_MESH_AXES=dp=2,ep=2 and --n-experts 4. A
pipeline over four ranks on dp=2, pp=2: NUM_PROCESSES=4,
KTWE_MESH_AXES=dp=2,pp=2 (the layer-stack form), plus
--pipeline-microbatches 2 for the GPipe schedule; the schedule on
pp=2, tp=2, sp=2: NUM_PROCESSES=8, KTWE_MESH_AXES=pp=2,tp=2,sp=2 and
--pipeline-microbatches 2.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import signal
import sys
import threading
from typing import Callable, Optional

import torch

from ..models import transformer as tf
from ..parallel import comm, pipeline
from ..parallel.mesh import MeshConfig, UnportedAxisError, check_supported
from ..train import bootstrap, trainer
from ..train.checkpoint import CheckpointManager, write_drain_marker
from ..train.data import DataConfig, make_input_pipeline
from ..train.profiling import H100_BF16_PEAK_TFLOPS, StepTimer

EXIT_REFUSED = 2


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ktwe-trainer-torch")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--d-model", type=int, default=2048)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--n-heads", type=int, default=16)
    p.add_argument("--d-ff", type=int, default=8192)
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("--n-experts", type=int, default=0,
                   help="MoE experts a layer (0 = the dense model)")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--checkpoint-dir", type=str, default="",
                   help="save the TrainState here (empty = no checkpoints)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="restore the latest step of --checkpoint-dir first "
                        "(also KTWE_RESUME=1)")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--profile-dir", type=str, default="",
                   help="accepted and unused, as in the JAX trainer")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--grad-accum-dtype", type=str, default="bf16",
                   choices=["bf16", "f32"],
                   help="accumulator dtype of the microbatch gradients")
    p.add_argument("--data-file", type=str, default="",
                   help="KTWE token shard (train/data.py); empty = "
                        "synthetic LM data")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="train through the explicit GPipe schedule "
                        "(parallel/pipeline.gpipe_lm_loss) with this many "
                        "microbatches; needs a pp>1 mesh (KTWE_MESH_AXES) "
                        "and batch-size divisible by it. 0 = the "
                        "layer-stack pp path")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def refused(args: argparse.Namespace,
            mesh_cfg: Optional[MeshConfig] = None) -> Optional[str]:
    """Why the arguments, on the mesh `mesh_cfg` the gang env asks for,
    ask for something not ported yet, or None (every mesh axis and flag
    of the JAX trainer is ported)."""
    if mesh_cfg is None:
        return None
    try:
        check_supported(mesh_cfg)
    except UnportedAxisError as e:
        return str(e)
    return None


def check_pipeline(args: argparse.Namespace, mesh_cfg: MeshConfig) -> None:
    """`--pipeline-microbatches`' two checks, with the JAX trainer's
    messages (SystemExit). Any other axis may be live beside pp: the
    schedule splits the batch over dp and ep and runs the stage whole on
    every tp and sp rank, as JAX's does."""
    if args.pipeline_microbatches <= 0:
        return
    if mesh_cfg.pp <= 1:
        raise SystemExit(
            "--pipeline-microbatches needs a pp>1 mesh axis "
            f"(got meshAxes [{mesh_cfg.describe()}])")
    if args.batch_size % args.pipeline_microbatches:
        raise SystemExit(
            f"--batch-size {args.batch_size} not divisible by "
            f"--pipeline-microbatches {args.pipeline_microbatches}")


def data_config(args: argparse.Namespace, tcfg: trainer.TrainConfig,
                dp: int, dp_rank: int) -> DataConfig:
    """The token pipeline of batch coordinate `dp_rank` of `dp` (the
    mesh's (dp, ep) coordinates, dp major, or on the GPipe path the
    schedule's batch axes): its rows of every microbatch of the global
    batch the shard's windows make at a step (the pipeline's split).
    Ranks of one coordinate read the same rows."""
    return DataConfig(path=args.data_file, batch_size=tcfg.batch_size // dp,
                      seq_len=tcfg.seq_len, seed=tcfg.seed,
                      process_id=dp_rank, num_processes=dp,
                      grad_accum=tcfg.grad_accum)


def main(argv=None, callback: Optional[Callable] = None,
         env: Optional[dict] = None, group_of_one: bool = False) -> int:
    """Train; `callback(i, metrics)` (optional) runs after each step; `env`
    is the gang env (default: os.environ); `group_of_one` is
    `bootstrap.initialize`'s."""
    args = build_parser().parse_args(argv)
    mesh_cfg = bootstrap.mesh_config(env, group_of_one)
    check_pipeline(args, mesh_cfg)
    why = refused(args, mesh_cfg)
    if why is None:
        try:
            ctx = bootstrap.initialize(env, device=args.device,
                                       group_of_one=group_of_one)
        except UnportedAxisError as e:
            why = str(e)
    if why is not None:
        print(f"ktwe-trainer-torch: {why}", file=sys.stderr, flush=True)
        return EXIT_REFUSED
    try:
        return _train(args, ctx, callback)
    finally:
        ctx.close()


def _train(args: argparse.Namespace, ctx: bootstrap.BootstrapContext,
           callback: Optional[Callable]) -> int:
    device, mesh = ctx.device, ctx.mesh
    world, primary = ctx.num_processes, ctx.is_primary
    model_cfg = tf.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_heads, d_ff=args.d_ff, max_seq=args.seq_len,
        n_experts=args.n_experts, remat=args.remat,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    tcfg = trainer.TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        seq_len=args.seq_len, total_steps=args.steps,
        grad_accum=args.grad_accum, grad_accum_dtype=args.grad_accum_dtype,
        seed=args.seed)
    sp = ctx.mesh_config.sp if mesh is not None else 1
    if tcfg.seq_len % sp:
        raise ValueError(f"--seq-len {tcfg.seq_len} cannot be split over "
                         f"sp={sp}")
    gen = torch.Generator(device=device)
    gen.manual_seed(tcfg.seed)
    state = trainer.init_state(model_cfg, tcfg, gen, mesh)
    # The batch splits over the (dp, ep) batch coordinates: the ranks of
    # one coordinate (its pp, tp and sp ranks) read the same rows. On the
    # GPipe path over the schedule's batch axes (JAX's three cases).
    loss_fn, split = None, None
    if args.pipeline_microbatches > 0:
        m = args.pipeline_microbatches
        loss_fn = functools.partial(pipeline.gpipe_lm_loss,
                                    num_microbatches=m)
        if state.fsdp is not None:
            split = pipeline.batch_split(state.fsdp,
                                         tcfg.microbatch_size // m)
    dp, dp_rank = (split or (state.fsdp.batch_ranks, state.fsdp.batch_rank)
                   if state.fsdp is not None else (1, 0))
    if tcfg.microbatch_size % dp:
        raise ValueError(f"--batch-size {tcfg.batch_size} / --grad-accum "
                         f"{tcfg.grad_accum} rows a microbatch cannot be "
                         f"split over dp*ep={dp}")
    mgr = CheckpointManager(args.checkpoint_dir) if args.checkpoint_dir \
        else None
    # KTWE_RESUME=1 is how the controller relaunches a drained tenant (it
    # re-creates the captured pod spec and cannot rewrite argv safely).
    if os.environ.get("KTWE_RESUME") == "1":
        args.resume = True
    if mgr is not None and args.resume and mgr.latest_step() is not None:
        state = mgr.restore(None, state)
        print(f"resumed from step {state.step}", flush=True)
    if args.data_file:
        batches = make_input_pipeline(
            data_config(args, tcfg, dp, dp_rank), start_step=state.step,
            device=device)
    else:
        batches = trainer.synthetic_batches(model_cfg, tcfg, device,
                                            state.fsdp, split)
    timer = StepTimer(peak_tflops=H100_BF16_PEAK_TFLOPS * world)
    # Drain: SIGTERM only sets a flag; the loop finishes the step in flight
    # and the ranks agree on it (`agree`), then main saves the step, writes
    # the drain marker and returns 0.
    drain = threading.Event()
    agreed = {"drain": False}
    moe = {}          # the last step's aux, for an MoE model only

    def agree() -> bool:
        if mesh is None:
            return drain.is_set()
        flag = torch.tensor([int(drain.is_set())], dtype=torch.int32,
                            device=device)
        comm.all_reduce(flag, op="max")
        return bool(flag.item())

    def on_step(i, metrics):
        if callback is not None:
            callback(i, metrics)
        agreed["drain"] = agree()
        if model_cfg.is_moe:
            moe["aux"] = float(metrics["aux"])
        if primary and (i + 1) % 10 == 0:
            s = timer.summary()
            print(json.dumps({"step": i + 1, "loss": float(metrics["loss"]),
                              **moe,
                              "tokens_per_s": round(s["tokens_per_s"], 1),
                              "mfu_pct": round(s["mfu_pct"], 2)}),
                  flush=True)
        if (mgr is not None and not agreed["drain"]
                and (i + 1) % args.checkpoint_every == 0):
            mgr.save(i + 1, state, wait=False)

    # The handler stays until main returns, so a second SIGTERM during the
    # drain's save does not kill the process.
    in_main = threading.current_thread() is threading.main_thread()
    previous = (signal.signal(signal.SIGTERM, lambda *_: drain.set())
                if in_main else None)
    try:
        out = trainer.train_loop(model_cfg, tcfg, args.steps,
                                 callback=on_step, device=device,
                                 stop=lambda: agreed["drain"], timer=timer,
                                 state=state, batches=batches,
                                 loss_fn=loss_fn)
        if agreed["drain"]:
            if mgr is not None:
                mgr.save(state.step, state, wait=True)
                if primary:
                    write_drain_marker(args.checkpoint_dir, state.step)
                mgr.close()
            if primary:
                print(json.dumps({"drained": True, "step": state.step,
                                  "loss": out["final_loss"]}), flush=True)
            return 0
        if mgr is not None:
            mgr.save(args.steps, state, wait=True)
            mgr.close()
        if primary:
            print(json.dumps({"final": True, **moe, **timer.summary()}),
                  flush=True)
        return 0
    finally:
        if in_main:
            signal.signal(signal.SIGTERM, previous if previous is not None
                          else signal.SIG_DFL)


if __name__ == "__main__":
    sys.exit(main())
