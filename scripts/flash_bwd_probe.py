"""Probe of the flash-attention backward kernels on one NVIDIA card: how
far each bf16 kernel output is from its plain version, and the kernels'
device times at the trainer's shape.

For each shape (B, S, H, D) bf16 causal, inputs drawn as chip_smoke.py
draws its training cases (or, for the first shape, as the card tests do),
it prints one JSON line: the entries of dQ, dK and dV (recompute dK/dV)
outside the backward limits of chip_smoke.py (rtol 2^-7, atol 1e-3 of the
output's root mean square), and, where the p/ds stash fits under the
PDS_STASH_LIMIT_BYTES gate, the entries of the P and dS stashes that
differ from the plain version's at all. Then the device milliseconds a
call of dQ (no stash) and of the recompute dK/dV at (8, 2048, 16, 128):
10 eager calls between CUDA events after 2 warm-up calls. Exits 1 without
a card. Imports torch and the port only.

    python3 scripts/flash_bwd_probe.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BWD_RTOL, BWD_ATOL_OF_RMS = 2.0 ** -7, 1e-3
SHAPES = ((1, 2048, 4, 128, "card tests"), (4, 2048, 16, 128, "chip_smoke"),
          (8, 2048, 16, 128, "chip_smoke"))


def out_of_limits(got: torch.Tensor, want: torch.Tensor) -> int:
    g, w = got.float(), want.float()
    rms = float(torch.linalg.vector_norm(w)) / max(1, w.numel()) ** 0.5
    return int(((g - w).abs() > BWD_ATOL_OF_RMS * rms + BWD_RTOL * w.abs())
               .sum())


def inputs(dev, shape, draw):
    b, s, h, d = shape
    if draw == "chip_smoke":
        gen = torch.Generator(device=dev).manual_seed(4)
        return [torch.randn((b, s, h, d), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(4)]
    out = []
    for seed in (2, 3, 4, 5):
        gen = torch.Generator(device=dev).manual_seed(seed)
        out.append(torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16))
    return out


def device_ms(fn, calls: int = 10) -> float:
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import flash_attention as flash
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for b, s, h, d, draw in SHAPES:
        q, k, v, do = inputs(dev, (b, s, h, d), draw)
        o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
        args = (q, k, v, do, lse, flash.backward_delta(o, do))
        line = dict(shape=[b, s, h, d], inputs=draw,
                    body=flash.bwd_body(flash.KERNEL_BWD_DQ, d, q.dtype)["body"])
        with torch.no_grad():
            stash = flash.stash_bytes(q, k, do) <= flash.PDS_STASH_LIMIT_BYTES
            dq, p_st, ds_st = flash.flash_bwd_dq(*args, stash=stash)
            want_dq, want_p, want_ds = flash.flash_bwd_dq_plain(*args,
                                                                stash=stash)
            line["dq_out_of_limits"] = out_of_limits(dq, want_dq)
            if stash:
                line["p_stash_entries_differing"] = int((p_st != want_p).sum())
                line["ds_stash_entries_differing"] = int((ds_st != want_ds)
                                                         .sum())
            del p_st, ds_st, want_p, want_ds, dq, want_dq
            dk, dv = flash.flash_bwd_dkv(*args)
            want_dk, want_dv = flash.flash_bwd_dkv_plain(*args)
            line["dk_out_of_limits"] = out_of_limits(dk, want_dk)
            line["dv_out_of_limits"] = out_of_limits(dv, want_dv)
            line["outputs"] = 3 * q.numel()
        print(json.dumps(line), flush=True)
        if (b, s, h, d) == (8, 2048, 16, 128):
            print(json.dumps({"device_ms": dict(
                shape=[b, s, h, d],
                dq=device_ms(lambda: flash.flash_bwd_dq(*args)),
                dkv=device_ms(lambda: flash.flash_bwd_dkv(*args)))}),
                flush=True)
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
