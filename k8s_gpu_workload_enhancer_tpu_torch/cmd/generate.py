"""Single-stream inference main of the PyTorch port (models/decode.py).

Port of k8s_gpu_workload_enhancer_tpu/cmd/generate.py: a seeded random
model prefills a seeded random prompt batch and decodes, then one JSON line
reports the throughput (prefill and per-token decode separated).
`--speculate-draft-layers N` then also runs early-exit self-drafting
speculative decoding (models/speculative.py; batch 1, greedy): its stats go
under the line's "speculative" key and its tokens into "sample_tail".

`--tensor-parallel N` shards heads, the MLP hidden, the vocab and the KV
cache over a tp axis of N ranks of a gang (one process a rank, from the
launcher env: COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID; the other
ranks form the dp axis, dp = NUM_PROCESSES / N). Every rank runs
`generate` on its shard with the same seed: its dp block of the batch, or
the whole batch where dp does not divide it. Rank 0 prints the line.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.generate \
        --prompt-len 128 --gen-len 64 --batch-size 8
    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.generate \
        --batch-size 1 --speculate-draft-layers 4 --speculate-k 4
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..models import decode, speculative, transformer as tf
from ..ops.quant import quantize_leaf
from ..train import bootstrap
from ..utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ktwe-generate-torch")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=128)
    p.add_argument("--gen-len", type=int, default=64)
    p.add_argument("--d-model", type=int, default=1024)
    p.add_argument("--n-layers", type=int, default=8)
    p.add_argument("--n-heads", type=int, default=8)
    p.add_argument("--n-kv-heads", type=int, default=0,
                   help="0 = same as --n-heads (MHA); fewer = GQA")
    p.add_argument("--d-ff", type=int, default=4096)
    p.add_argument("--vocab-size", type=int, default=32768)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize-int8", action="store_true",
                   help="weight-only int8 quantization (ops/quant.py)")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="shard heads/MLP/vocab + the KV cache over a tp "
                        "axis of this size (models bigger than one card); "
                        "the gang's other ranks form the dp axis")
    p.add_argument("--speculate-draft-layers", type=int, default=0,
                   help="early-exit self-drafting speculative decoding "
                        "(models/speculative.py): the draft is the "
                        "target's FIRST N layers sharing the same "
                        "embed/head weights (no extra HBM). Output is "
                        "target-equivalent regardless of draft quality; "
                        "requires --batch-size 1 and greedy. 0 = off")
    p.add_argument("--speculate-k", type=int, default=4,
                   help="draft tokens proposed per verify round")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def early_exit_draft(params: tf.Params, cfg: tf.TransformerConfig,
                     n: int) -> tuple:
    """(draft params, draft cfg): the target's first `n` layers, sharing
    its embedding, head and norms (only the stacked layer leaves are
    sliced, quantized q8/scale pairs together; views, no copies)."""
    def first(node):
        if isinstance(node, dict):
            return {k: first(v) for k, v in node.items()}
        return node[:n]
    draft = {k: v for k, v in params.items() if k != "layers"}
    draft["layers"] = first(params["layers"])
    return draft, dataclasses.replace(cfg, n_layers=n)


def _run_speculative(args, cfg: tf.TransformerConfig, params: tf.Params,
                     prompt: torch.Tensor, mesh=None) -> tuple:
    """Early-exit self-draft speculative generation of `prompt` (1, P):
    one warm-up run (the kernels' builds), one timed. Whatever the draft
    accepts, the greedy verify makes the tokens the target's; the knob
    trades draft compute for accepted tokens a round (reported). Returns
    (the stats, the tokens (1, P + gen_len))."""
    n = args.speculate_draft_layers
    draft, draft_cfg = early_exit_draft(params, cfg, n)
    max_seq = args.prompt_len + args.gen_len + args.speculate_k + 1

    def run():
        return speculative.generate_speculative(
            params, cfg, draft, draft_cfg, prompt, args.gen_len,
            k=args.speculate_k, max_seq=max_seq, mesh=mesh)
    run()
    _sync(prompt.device)
    t0 = time.perf_counter()
    toks, rounds = run()
    _sync(prompt.device)
    wall = time.perf_counter() - t0
    stats = speculative.spec_stats(rounds, args.gen_len)
    return {
        "draft_layers": n, "k": args.speculate_k,
        "rounds": stats.rounds,
        "tokens_per_round": round(stats.tokens_per_round, 2),
        "wall_s": round(wall, 4),
        "tokens_per_s": round(args.gen_len / wall, 1),
    }, toks


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.gen_len < 1:
        build_parser().error("--gen-len must be >= 1")
    if args.speculate_draft_layers > 0:
        # Validate everything before the baseline runs.
        if args.batch_size != 1 or args.temperature > 0:
            build_parser().error(
                "--speculate-draft-layers needs --batch-size 1 and "
                "greedy (temperature 0) — speculation is per-stream")
        if args.speculate_draft_layers >= args.n_layers:
            build_parser().error(
                f"--speculate-draft-layers {args.speculate_draft_layers}"
                f" must be < --n-layers {args.n_layers} (the draft is a"
                f" strict early exit)")
        if args.speculate_k < 1:
            build_parser().error("--speculate-k must be >= 1")
    n = int(os.environ.get("NUM_PROCESSES", "1"))
    tp = args.tensor_parallel
    if tp < 1 or n % tp or args.n_heads % tp or args.vocab_size % tp \
            or args.d_ff % tp:
        build_parser().error(
            f"--tensor-parallel {tp} must divide the device count ({n}), "
            f"n_heads, d_ff, and vocab_size")
    gang, mesh = None, None
    if n > 1:
        gang, mesh = bootstrap.initialize_serving((n // tp, tp),
                                                  device=args.device)
    device = resolve_device(args.device)
    max_seq = args.prompt_len + args.gen_len
    cfg = tf.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads or args.n_heads, d_ff=args.d_ff,
        max_seq=max_seq,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)

    def finish(name: str, leaf: torch.Tensor):
        # Each leaf as it is drawn: int8, and on a mesh the rank's block.
        if args.quantize_int8:
            leaf = quantize_leaf(name, leaf)
        if mesh is not None:
            leaf = decode.shard_params_for_serving({name: leaf}, cfg,
                                                   mesh)[name]
        return leaf
    params = tf.init_params(gen, cfg, finish=finish)
    prompt = torch.randint(0, cfg.vocab_size,
                           (args.batch_size, args.prompt_len),
                           generator=gen, device=device)
    if mesh is not None:
        # Every rank drew the same tree and batch: it keeps its blocks and
        # its dp block of the rows (all of them where dp does not divide
        # the batch, as GSPMD's padding computes the same function).
        if args.batch_size % mesh.dp == 0:
            rows = args.batch_size // mesh.dp
            prompt = prompt[mesh.dp_rank * rows:(mesh.dp_rank + 1) * rows]

    def timed(num_steps: int):
        sampler = torch.Generator(device=device)
        sampler.manual_seed(args.seed + 1)
        run = lambda: decode.generate(          # noqa: E731
            params, prompt, num_steps, cfg, max_seq=max_seq,
            temperature=args.temperature, top_k=args.top_k,
            generator=sampler, mesh=mesh)
        run()                                   # warm-up: kernel builds
        _sync(device)
        t0 = time.perf_counter()
        out = run()
        _sync(device)
        return time.perf_counter() - t0, out

    dt_prefill, _ = timed(1)                    # prefill + 1 token
    dt, out = timed(args.gen_len)               # prefill + gen_len tokens
    spec_stats = None
    if args.speculate_draft_layers > 0:
        spec_stats, out = _run_speculative(args, cfg, params, prompt, mesh)
    decode_steps = max(args.gen_len - 1, 1)
    decode_ms = 1e3 * max(dt - dt_prefill, 0.0) / decode_steps
    if gang is not None:
        gang.close()
        if not mesh.is_driver:
            return 0
    print(json.dumps({
        **({"speculative": spec_stats} if spec_stats else {}),
        "devices": (mesh.size if mesh is not None else
                    torch.cuda.device_count() if device.type == "cuda"
                    else 1),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "batch": args.batch_size,
        "prompt_len": args.prompt_len,
        "gen_len": args.gen_len,
        "int8": bool(args.quantize_int8),
        "tensor_parallel": args.tensor_parallel,
        "wall_s": round(dt, 4),
        "prefill_s": round(dt_prefill, 4),
        "tokens_per_s": round(args.batch_size * args.gen_len / dt, 1),
        "decode_ms_per_token": round(decode_ms, 3),
        "sample_tail": [int(x) for x in out[0, -5:].tolist()],
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
