"""Trainer main of the PyTorch port: single-device training of KTWE-LM.

Port of k8s_gpu_workload_enhancer_tpu/cmd/trainer.py on one device, with
the same flags and defaults (vocab 32768, d_model 2048, 8 layers, 16
heads, d_ff 8192, seq 2048, batch 8) plus `--device` (cuda by default;
raises without a card) and `--seed`. It trains on seeded synthetic LM data
in bf16 on the card (f32 on the CPU), prints a JSON line every 10 steps
and a final summary line, and on SIGTERM finishes the step in flight and
prints a `drained` line.

Not ported yet, and refused with exit code 2 rather than ignored:
`--checkpoint-dir` / `--resume` and `--data-file` (ROADMAP A10:
train/checkpoint.py, train/data.py), `--pipeline-microbatches` and
`--n-experts` (ROADMAP A11: pipeline parallelism, MoE). `--profile-dir`
is accepted and unused, as in the JAX trainer.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer --steps 20
    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.trainer --device cpu \
        --steps 10 --batch-size 2 --seq-len 32 --d-model 64 --n-layers 2 \
        --n-heads 2 --d-ff 128 --vocab-size 256
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading
from typing import Callable, Optional

import torch

from ..models import transformer as tf
from ..train import trainer
from ..train.profiling import StepTimer
from ..utils.device import resolve_device

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
                   help="MoE experts; not ported yet (0 only)")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--checkpoint-dir", type=str, default="",
                   help="not ported yet (empty only)")
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.add_argument("--resume", action="store_true",
                   help="not ported yet")
    p.add_argument("--remat", action="store_true")
    p.add_argument("--profile-dir", type=str, default="",
                   help="accepted and unused, as in the JAX trainer")
    p.add_argument("--grad-accum", type=int, default=1)
    p.add_argument("--grad-accum-dtype", type=str, default="bf16",
                   choices=["bf16", "f32"],
                   help="accumulator dtype of the microbatch gradients")
    p.add_argument("--data-file", type=str, default="",
                   help="token shards; not ported yet (empty = synthetic "
                        "LM data, the only source)")
    p.add_argument("--pipeline-microbatches", type=int, default=0,
                   help="the explicit GPipe schedule; not ported yet "
                        "(0 only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def refused(args: argparse.Namespace) -> Optional[str]:
    """Why the arguments ask for something not ported yet, or None."""
    if args.checkpoint_dir or args.resume:
        return ("--checkpoint-dir/--resume: checkpointing is not ported yet "
                "(ROADMAP A10, train/checkpoint.py)")
    if args.data_file:
        return ("--data-file: the token-shard input pipeline is not ported "
                "yet (ROADMAP A10, train/data.py)")
    if args.pipeline_microbatches > 0:
        return ("--pipeline-microbatches: pipeline parallelism is not "
                "ported yet (ROADMAP A11); the port trains on one device")
    if args.n_experts > 0:
        return "--n-experts: MoE layers are not ported yet (ROADMAP A11)"
    return None


def main(argv=None, callback: Optional[Callable] = None) -> int:
    """Train; `callback(i, metrics)` (optional) runs after each step."""
    args = build_parser().parse_args(argv)
    why = refused(args)
    if why is not None:
        print(f"ktwe-trainer-torch: {why}", file=sys.stderr, flush=True)
        return EXIT_REFUSED
    device = resolve_device(args.device)
    model_cfg = tf.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_heads, d_ff=args.d_ff, max_seq=args.seq_len,
        remat=args.remat,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    tcfg = trainer.TrainConfig(
        learning_rate=args.learning_rate, batch_size=args.batch_size,
        seq_len=args.seq_len, total_steps=args.steps,
        grad_accum=args.grad_accum, grad_accum_dtype=args.grad_accum_dtype,
        seed=args.seed)
    timer = StepTimer()

    def on_step(i, metrics):
        if callback is not None:
            callback(i, metrics)
        if (i + 1) % 10 == 0:
            s = timer.summary()
            print(json.dumps({"step": i + 1, "loss": float(metrics["loss"]),
                              "tokens_per_s": round(s["tokens_per_s"], 1),
                              "mfu_pct": round(s["mfu_pct"], 2)}),
                  flush=True)

    # Drain: SIGTERM only sets a flag; the loop finishes the step in flight,
    # then main prints the drained line and returns 0.
    drain = threading.Event()
    in_main = threading.current_thread() is threading.main_thread()
    previous = (signal.signal(signal.SIGTERM, lambda *_: drain.set())
                if in_main else None)
    try:
        out = trainer.train_loop(model_cfg, tcfg, args.steps,
                                 callback=on_step, device=device,
                                 stop=drain.is_set, timer=timer)
    finally:
        if in_main:
            signal.signal(signal.SIGTERM, previous if previous is not None
                          else signal.SIG_DFL)
    if drain.is_set():
        print(json.dumps({"drained": True, "step": out["steps_run"],
                          "loss": out["final_loss"]}), flush=True)
        return 0
    print(json.dumps({"final": True, **timer.summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
