"""Probe of the fused LM-head cross-entropy kernels on one NVIDIA card: how
far each output is from its plain version, the device time of each kernel
launch, and the yardsticks, at the flagship's shape.

For each case (N, D, V, dtype), inputs drawn as chip_smoke.py draws its
fused CE cases, it prints one JSON line: the body and tile the library
runs, the forward's largest lse and gold relative errors and the stash
entries that differ from the plain version's (and those more than one bf16
ulp apart), the backward's dlg entries that differ and dH's entries
outside the backward limits of chip_smoke.py (rtol 2^-7, atol 1e-3 of dH's
root mean square); device ms of a forward and a backward call (10 calls
between CUDA events after 2 warm-up calls), those of the yardsticks
(torch.matmul + F.cross_entropy, and their backward to the hidden), and a
torch.profiler split of one forward and one backward call into their
kernel launches. Cases: the flagship microbatch (16384, 2048, 32768) bf16
and the f32 gate's rows (512, 2048, 32768). Exits 1 without a card.
Imports torch and the port only.

    python3 scripts/fused_ce_probe.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BWD_RTOL, BWD_ATOL_OF_RMS = 2.0 ** -7, 1e-3
CASES = ((16384, 2048, 32768, torch.bfloat16),
         (512, 2048, 32768, torch.float32))


def events_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launches_ms(fn) -> dict:
    """Device ms of each kernel launch of one call of fn, by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name[:60]
            out[name] = out.get(name, 0.0) + (e.time_range.end
                                              - e.time_range.start) / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_ce_probe: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.ops import fused_ce, kernels
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"build_s": kernels.build(["fused_ce"])}), flush=True)
    print(kernels.build_log("fused_ce"), flush=True)
    dev = torch.device("cuda", 0)
    F = torch.nn.functional
    for n, d, v, dt in CASES:
        gen = torch.Generator(device=dev).manual_seed(6)
        h2 = torch.randn((n, d), generator=gen, device=dev).to(dt)
        head = (0.05 * torch.randn((d, v), generator=gen, device=dev)).to(dt)
        t1 = torch.randint(0, v, (n,), generator=gen, device=dev)
        lse, gold, stash = fused_ce.fused_ce_forward(h2, head, t1)
        w_lse, w_gold, w_stash = fused_ce.fused_ce_forward_plain(h2, head, t1)
        scale = torch.tensor([1.0 / n], device=dev)
        dlg, dh = fused_ce.fused_ce_backward(w_stash, head, w_lse, t1, scale)
        w_dlg, w_dh = fused_ce.fused_ce_backward_plain(w_stash, head, w_lse,
                                                       t1, scale)
        sd = (stash.float() - w_stash.float()).abs()
        g, w = dh.float(), w_dh.float()
        rms = float(torch.linalg.vector_norm(w)) / w.numel() ** 0.5
        row = dict(
            n=n, d=d, v=v, dtype=str(dt).split(".")[-1],
            fwd=fused_ce.body_report(fused_ce.KERNEL_FWD, dt),
            bwd=fused_ce.body_report(fused_ce.KERNEL_BWD, dt),
            lse_max_rel_err=float(((lse - w_lse).abs()
                                   / w_lse.abs().clamp_min(1e-6)).max()),
            gold_max_rel_err=float(((gold - w_gold).abs()
                                    / w_gold.abs().clamp_min(1e-6)).max()),
            stash_differ=int((sd > 0).sum()),
            stash_over_one_ulp=int((sd > w_stash.float().abs() / 128).sum()),
            dlg_differ=int((dlg != w_dlg).sum()),
            dh_out_of_limits=int(((g - w).abs() > BWD_ATOL_OF_RMS * rms
                                  + BWD_RTOL * w.abs()).sum()))
        del lse, gold, stash, dlg, dh, w_dlg, w_dh, sd, g, w
        hl = h2.detach().requires_grad_()
        loss = F.cross_entropy((hl @ head).float(), t1)
        row.update(
            fwd_ms=events_ms(lambda: fused_ce.fused_ce_forward(h2, head, t1)),
            bwd_ms=events_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale)),
            library_fwd_ms=events_ms(lambda: F.cross_entropy(
                (h2 @ head).float(), t1)),
            library_bwd_ms=events_ms(lambda: torch.autograd.grad(
                loss, (hl,), retain_graph=True)),
            fwd_launches_ms=launches_ms(
                lambda: fused_ce.fused_ce_forward(h2, head, t1)),
            bwd_launches_ms=launches_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale)))
        print(json.dumps(row), flush=True)
        del h2, head, t1, w_lse, w_gold, w_stash, hl, loss
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
