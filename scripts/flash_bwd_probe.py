"""Probe of the flash-attention backward kernels on one NVIDIA card: how
far each bf16 kernel output is from its plain version, how often the
in-order recheck runs, and the kernels' device times at the main path's
shapes.

For each shape (B, S, H, D) bf16 causal, inputs drawn as chip_smoke.py
draws its training cases (or, for the first shape, as the card tests do),
it prints one JSON line: the entries of dQ, dK and dV outside the backward
limits of chip_smoke.py (rtol 2^-7, atol 1e-3 of the output's root mean
square), for the recompute dK/dV and, where the p/ds stash fits under the
PDS_STASH_LIMIT_BYTES gate, for the stash dK/dV; the entries of the P and
dS stashes that differ from the plain version's at all; and the share of
visible (query, key) elements whose P and dS the dQ kernel's tensor-core
body rechecked as in-order chains (`ktwe_flash_bwd_dq_flagged`). Shapes:
the card tests' (1, 2048, 4, 128), the trainer's batch-4 stash shape
(4, 2048, 16, 128) and batch-8 shape (8, 2048, 16, 128), and the flagship
microbatch on its flat view (32, 2048, 1, 512). Then the device
milliseconds a call of each main-path kernel takes at its shape: 10 eager
calls between CUDA events after 2 warm-up calls. Exits 1 without a card.
Imports torch and the port only.

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
          (8, 2048, 16, 128, "chip_smoke"), (32, 2048, 1, 512, "chip_smoke"))


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


def flagged_share(flash, kernels, q, k, v, do, lse, delta) -> float:
    """Rechecked elements over visible (query, key) elements of one causal
    dQ launch (its stash written too, as on the stash path)."""
    b, s, h, d = q.shape
    count = torch.zeros(1, dtype=torch.int64, device=q.device)
    dq = torch.empty_like(q)
    p_st = torch.empty((b * h, s, s), dtype=q.dtype, device=q.device)
    ds_st = torch.empty_like(p_st)
    lib = kernels.library("flash_attention_bwd")
    code = lib.ktwe_flash_bwd_dq_flagged(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), p_st.data_ptr(),
        ds_st.data_ptr(), b, s, s, h, d, 1, 0, 0, float(d ** -0.5),
        kernels.DTYPE_CODES[q.dtype], q.device.index or 0,
        kernels.stream_handle(q), count.data_ptr())
    kernels.check(lib, "flash_attention_bwd_dq", code)
    return int(count.item()) / (b * h * s * (s + 1) // 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import flash_attention as flash
    from k8s_gpu_workload_enhancer_tpu_torch.ops import kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for b, s, h, d, draw in SHAPES:
        q, k, v, do = inputs(dev, (b, s, h, d), draw)
        o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
        delta = flash.backward_delta(o, do)
        args = (q, k, v, do, lse, delta)
        line = dict(shape=[b, s, h, d], inputs=draw,
                    dq_body=flash.bwd_body(flash.KERNEL_BWD_DQ, d, q.dtype),
                    dq_flagged_share=flagged_share(flash, kernels, *args))
        times = {}
        with torch.no_grad():
            stash = flash.stash_bytes(q, k, do) <= flash.PDS_STASH_LIMIT_BYTES
            dq, p_st, ds_st = flash.flash_bwd_dq(*args, stash=stash)
            want_dq, want_p, want_ds = flash.flash_bwd_dq_plain(*args,
                                                                stash=stash)
            line["dq_out_of_limits"] = out_of_limits(dq, want_dq)
            del dq, want_dq
            if stash:
                line["p_stash_entries_differing"] = int((p_st != want_p).sum())
                line["ds_stash_entries_differing"] = int((ds_st != want_ds)
                                                         .sum())
                del want_p, want_ds
                dk, dv = flash.flash_bwd_dkv_from_stash(q, k, v, do, p_st,
                                                        ds_st)
                want_dk, want_dv = flash.flash_bwd_dkv_from_stash_plain(
                    q, k, v, do, p_st, ds_st)
                line["stash_dk_out_of_limits"] = out_of_limits(dk, want_dk)
                line["stash_dv_out_of_limits"] = out_of_limits(dv, want_dv)
                del dk, dv, want_dk, want_dv
                times["dq_with_stash"] = device_ms(
                    lambda: flash.flash_bwd_dq(*args, stash=True))
                times["dkv_from_stash"] = device_ms(
                    lambda: flash.flash_bwd_dkv_from_stash(q, k, v, do, p_st,
                                                           ds_st))
            del p_st, ds_st
            torch.cuda.empty_cache()
            dk, dv = flash.flash_bwd_dkv(*args)
            want_dk, want_dv = flash.flash_bwd_dkv_plain(*args)
            line["dk_out_of_limits"] = out_of_limits(dk, want_dk)
            line["dv_out_of_limits"] = out_of_limits(dv, want_dv)
            line["outputs"] = 3 * q.numel()
            del dk, dv, want_dk, want_dv
            if not stash:
                times["dq"] = device_ms(lambda: flash.flash_bwd_dq(*args))
                times["dkv_recompute"] = device_ms(
                    lambda: flash.flash_bwd_dkv(*args))
        line["device_ms"] = times
        print(json.dumps(line), flush=True)
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
