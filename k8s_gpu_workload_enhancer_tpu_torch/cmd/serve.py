"""Serving main of the PyTorch port: the continuous-batching engine behind
an HTTP JSON surface.

Port of the default path of k8s_gpu_workload_enhancer_tpu/cmd/serve.py: a
background loop steps `models/serving.ContinuousBatchEngine` whenever work
is pending, and `/v1/generate` blocks its caller until the request
finishes (or streams it). Request and reply fields are named as in the JAX
service (fleet/wire.py of the JAX package is the schema), so the fleet's
router, autoscaler and registry drive this replica as they drive a JAX one.

POST /v1/generate {"prompt": [ids], "maxNewTokens": N, "timeoutSeconds": s,
"temperature"?, "topP"?, "stop"?, "prngKey"?, "prefixId"?, "resumeFrom"?,
"tenant"?, "priority"?}
-> {"status", "requestId", "tokens", "logprobs", "finishReason", "ttftMs"};
with {"stream": true} the reply is NDJSON, one {"tokens", "offset",
"requestId"} line per batch of new tokens and then the final view. A
timeout or an abandoned stream CANCELS the request, freeing its slot. A
full queue answers 429 with Retry-After. "prngKey" (two uint32 words) is
the request's sampling key: the same key at the same temperature gives the
same tokens. "prefixId" prepends a registered prefix. "resumeFrom" (a
migrate frame's "resume": prompt, committed, maxNewTokens, sampling params,
stop, prngKey) continues another replica's generation: the committed
tokens are context, count against maxNewTokens and are never re-emitted
(streams start at offset len(committed); the final view carries
"committedOffset"). "stopText" and "text" need a tokenizer, which is not
ported, and answer 400 naming the field. A request's "traceparent" header
is echoed in its final view.

Tenancy, as the JAX serve resolves it: "tenant" and "priority" come from
the body, else the x-ktwe-tenant / x-ktwe-priority headers, else a
resumeFrom carry, else --default-tenant and "interactive"; any other
priority than "interactive" or "batch" is a 400. Interactive requests are
admitted ahead of batch ones, and a decoding batch request is preempted
for an interactive one (its stream ends in a migrate frame with reason
"preempt"; --preempt-cap bounds the hops of one generation, 0 disables
it). Every terminal view is metered to its tenant (tokens, and slot
residency as chip-seconds priced at --chip-hour-rate); /v1/metrics
reports the meter in its `tenancy` block. With --tenant-budget NAME=DOLLARS
a fresh request of a tenant whose spend in the --budget-period has reached
its budget answers 429 with reason "budget-exhausted" and a Retry-After
that runs to the period's end; a resumeFrom continuation is never refused
for its budget, but is metered.

POST /v1/prefix {"tokens": [ids]} registers a shared prompt prefix ->
{"prefixId", "cachedTokens"}; {"releaseId": id} releases one (404 if
unknown). A full registry answers 429 without Retry-After (only a release
clears it), a paged pool that cannot hold the prefix 429 with Retry-After.
POST /v1/cancel {"requestId"}; POST or GET /v1/result {"requestId"} ->
the final view, or {"status": "pending", "tokensSoFar"} (404 unknown).
POST /v1/admin/eject ejects every live request as a resume state: each
stream ends with {"status": "migrate", "resume": {...}}, each blocking
caller gets that view. GET /v1/metrics, GET /health.
POST /v1/admin/reload {"checkpointDir"?} hot-swaps the weights to the
latest step of that directory (default --checkpoint-dir), re-prefilling
every registered prefix: 200 {"status": "ok", "step", "swapPauseMs"}; 503
without a checkpoint source, 404 when no checkpoint is found, 409 when the
restore fails or its tree does not match the engine's (the old weights
keep serving), 500 for any other swap failure. The restore runs outside
the engine lock; only the swap holds it.
With a bearer token (--auth-token, $KTWE_AUTH_TOKEN or the file at
$KTWE_AUTH_TOKEN_FILE, which must be readable when set) every route but
/health answers 401 without `Authorization: Bearer <token>`.

--kv-block-len N > 0 serves from the paged KV engine: pages of N tokens,
reserved per request, with automatic radix prefix reuse; /v1/metrics then
reports the pool in its `kv_cache` block, and its `kvhost` block a bloom
filter of the prefix digests the replica holds (rebuilt at most every
--kv-gossip-interval seconds), which the fleet's router reads to route a
prompt to the replica warm for it. --kv-host-blocks B > 0 (paged only;
exit 2 without --kv-block-len) puts a host-RAM tier of B blocks under the
pool (models/kvhost.py): evicted pages are demoted to it and a prompt
matching a demoted prefix restores it before its prefill;
--kv-offload-watermark F demotes ahead below a free fraction F. POST
/v1/kvhost {"digests": [...]} exports the tier's blocks of those digests
-> {"entries": [...]}; {"entries": [...]} imports a peer's -> {"imported":
n} (blocks of another backend, mesh or checksum are not counted); any
other body is a 400. --metrics-port P serves the
`ktwe_serving_*` Prometheus families (SERVING_FAMILIES) on GET /metrics.
--overlap-commit 0 commits each decode chunk before the next one is
dispatched (bisection; the tokens are the same); --watchdog-timeout S fails
the in-flight batch when a chunk has not landed S seconds after its
dispatch. --int8-kv stores the KV cache as int8 with per-row f32 scales
(models/decode.py), on both engines. --spec-k K > 0 decodes
speculatively (models/serving.py): up to K n-gram self-drafts a greedy
slot (--spec-ngram, the longest n-gram matched), verified in one
(K+1)-wide round; greedy tokens are those of --spec-k 0, /v1/metrics grows
its `spec` block and --metrics-port the ktwe_serving_spec_* families. It
refuses --int8-kv (exit 2).
KTWE_FAULT_SEED=N (with KTWE_FAULT_RATE and a comma-separated
KTWE_FAULT_SITES) activates a FaultLab plan at start (faultlab/; printed as
`[faultlab] ACTIVE: ...`); the engine's sites then inject faults, which
fail the requests their containment class fails, and /v1/metrics reports
them in its `faultlab` block (`ktwe_fault_injections_total` on
--metrics-port).
--config ktwe.yaml takes defaults from the file's `serve:` section (keys
are flag names with underscores); flags on the command line win, and a key
this main has no flag for is an error.

Observability, as the JAX serve has it. --trace-out PATH records one NDJSON
traffic-trace record per terminal view, and one per queue-pressure or
budget 429 (autopilot/trace.py); POST /v1/admin/trace {"action": "start" |
"stop" | "rotate" | "status"} drives it. --span-out PATH turns the flight
recorder on (observability/flight.py): every terminal view exports its span
tree (a `replica.generate` root that adopts the request's `traceparent`,
with admission, queue_wait, prefill and decode children and the eject
marks) as span NDJSON, driven by POST /v1/admin/spans; the final view then
carries "traceId". --slo-capture-threshold S (> 0, with or without
--span-out) also turns it on and keeps the span tree of every request
slower than S seconds for GET /v1/admin/slow-requests. With the recorder
on the engine records phase events (models/serving.py); with it off the
serving path runs no tracing code, each of these routes answers 400, and
the `spans` block and its families read 0. --optimizer-url URL pushes a
density point (tokens/s and token p99 by model bucket, --tenants, slots)
to the optimizer every --telemetry-interval seconds (at least 1), with this
serve's bearer token.

Disaggregated prefill/decode (--disagg): a "prefill" replica prefills each
request, lands its first token and ejects it as a migrate frame whose
resume has reason "handoff"; the fleet router splices the continuation
onto a "decode" replica. The role is advertised as `role` in /v1/metrics,
where the fleet's registry pools replicas by it ("mixed" with --disagg
off). The single-replica complement is --prefill-chunk-tokens N: N replaces
--prefill-len as the prompt slice (it must divide --max-seq, and a prefill
replica refuses it), and while a prompt is mid-slice or a request waits,
decode runs in quanta of decode-chunk/4 steps; only the schedule moves (on
the card a bf16 matmul over fewer rows may round otherwise).

--mesh dp,tp serves on a mesh of a gang (models/serving.py, the serving
meshes): one process a rank from the launcher env (COORDINATOR_ADDRESS,
NUM_PROCESSES = dp * tp, PROCESS_ID; one device a process, cuda:LOCAL_RANK
on the card, gloo with --device cpu). Rank 0 serves HTTP; the others run
the device programs it broadcasts and exit 0 when it stops them at its
shutdown (they ignore their own SIGTERM: the driver's drain is the
gang's). A bare N means tp=N; '', '1' and '1,1' one device; the default is
$KTWE_MESH. Exit 2, in the JAX serve's words: a malformed value, a gang of
another size than dp * tp, a tp that does not divide --n-heads, --d-ff or
--vocab-size, a dp that does not divide a dense engine's --num-slots. The
host KV tier (--kv-host-blocks) serves on a mesh too: rank 0 holds it, a
demotion gathers a page's KV-head shards to it and a restore sends the
page back to every rank; its `kvhost` block, the ktwe_serving_kvhost_*
families and /v1/kvhost (assembled pages, keyed by the mesh's signature)
are a single-device replica's. /v1/metrics reports the `mesh` block (devices, dp, tp, shape, degraded,
per_slice_mfu_pct: model FLOP/s over the mesh's peak), which the fleet
registry reads; after a device loss it reads one device, degraded. Each
rank's card holds its blocks of the weights and at most one full leaf
more; a checkpoint on a mesh is finished on the host.

SIGTERM drains: new submits get 503 + Retry-After, /health answers 503
"draining", accepted requests run on; at the eject grace whatever still
runs is ejected as migrate frames, then the process exits 0. The grace is
--drain-eject-grace seconds after the signal (0: two seconds, at most half
the budget, before --drain-timeout), never later than that
(`eject_grace_s`).

The weights are the latest step of a trainer checkpoint with
--checkpoint-dir (train/checkpoint.py; only the params are read, `restored
params from step N`), else a seeded random init (--seed). With
--watch-checkpoints S the directory is polled every S seconds and a new
step is hot-swapped in through the reload path. It runs on the card
(--device cuda, the default, which raises without one) in bf16, or on the
CPU in f32 with --device cpu.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.serve --port 8000
    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.serve \
        --checkpoint-dir ckpt --watch-checkpoints 30 --metrics-port 9400
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import time
from http.server import ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from .. import faultlab
from ..agent.optimizer_client import HTTPOptimizerClient
from ..autopilot.trace import TraceWriter, admin_trace
from ..cost.cost_engine import (BudgetPeriod, BudgetScope, CostEngine,
                                EnforcementPolicy, TenantMeter)
from ..models import decode, serving
from ..models import transformer as tf
from ..observability.flight import (ROOT_SPAN_REPLICA, FlightRecorder,
                                    zero_metrics)
from ..ops.quant import quantize_leaf
from ..train import bootstrap
from ..train.checkpoint import CheckpointManager
from ..train.profiling import H100_BF16_PEAK_TFLOPS
from ..utils.device import resolve_device
from ..utils.config import parse_with_config
from ..utils.httpjson import (StatusError, make_json_handler,
                              resolve_auth_token)
from ..utils.procmetrics import ProcMetricsServer
from ..utils.stats import LatencyWindow
from ..utils.tracing import (InMemoryExporter, JsonlExporter,
                             SlowRequestCapture, Tracer, admin_spans)

# The serve defaults of the JAX package's knob registry
# (autopilot/knobs.py, "serve" component), copied.
DEFAULTS = dict(port=8000, vocab_size=32768, d_model=2048,
                n_layers=3, n_heads=4, n_kv_heads=0, d_ff=16384, max_seq=256,
                int8=False, int8_kv=False, num_slots=8, prefill_len=128, decode_chunk=8,
                max_queue=64, prefill_interleave=2, eos_id=-1,
                drain_timeout=30.0, temperature=0.0, top_k=0, top_p=1.0,
                enable_top_p=False, kv_block_len=0, kv_num_blocks=0,
                max_prefixes=8, metrics_port=0, device="cuda", seed=0,
                auth_token="", checkpoint_dir="", watch_checkpoints=0.0,
                overlap_commit=1, watchdog_timeout=0.0, preempt_cap=2,
                default_tenant="anonymous", tenant_budget=[],
                budget_period="daily", chip_hour_rate=1.20, disagg="off",
                prefill_chunk_tokens=0, drain_eject_grace=0.0,
                optimizer_url="", telemetry_interval=30.0, tenants=1,
                trace_out="", span_out="", slo_capture_threshold=0.0,
                spec_k=0, spec_ngram=3, kv_host_blocks=0,
                kv_offload_watermark=0.0, kv_gossip_interval=30.0, mesh="")

# /v1/generate fields of the JAX service that this replica refuses (400
# naming the field) rather than drop, and why.
_UNPORTED_FIELDS = {
    "stopText": "it needs a tokenizer (--tokenizer is not ported)",
    "text": "it needs a tokenizer (--tokenizer is not ported); send "
            '"prompt" ids',
}

# The `ktwe_serving_*` Prometheus families (--metrics-port): the JAX serve's
# SERVING_FAMILIES, all of them, with the same names and meanings. Each maps
# (the /v1/metrics dict, slots_busy, num_slots) to a value; `_total`
# families read the engine's monotonic lifetime counters.
SERVING_FAMILIES = {
    "ktwe_serving_requests_completed_total":
        lambda m, b, s: m["lifetime"]["completed"],
    "ktwe_serving_requests_cancelled_total":
        lambda m, b, s: m["lifetime"]["cancelled"],
    "ktwe_serving_tokens_total": lambda m, b, s: m["lifetime"]["tokens"],
    "ktwe_serving_queue_depth": lambda m, b, s: m["queued"],
    "ktwe_serving_slots_busy": lambda m, b, s: b,
    "ktwe_serving_slots": lambda m, b, s: s,
    "ktwe_serving_tokens_per_second":
        lambda m, b, s: m["aggregate_tokens_per_s"],
    "ktwe_serving_token_latency_p50_ms":
        lambda m, b, s: m["token_lat_p50_ms"],
    "ktwe_serving_token_latency_p99_ms":
        lambda m, b, s: m["token_lat_p99_ms"],
    "ktwe_serving_ttft_p50_ms": lambda m, b, s: m["ttft_p50_ms"],
    "ktwe_serving_ttft_p95_ms": lambda m, b, s: m["ttft_p95_ms"],
    "ktwe_serving_ttft_p99_ms": lambda m, b, s: m["ttft_p99_ms"],
    "ktwe_serving_request_latency_p50_ms":
        lambda m, b, s: m["request_lat_ms"]["p50_ms"],
    "ktwe_serving_request_latency_p95_ms":
        lambda m, b, s: m["request_lat_ms"]["p95_ms"],
    "ktwe_serving_request_latency_p99_ms":
        lambda m, b, s: m["request_lat_ms"]["p99_ms"],
    "ktwe_serving_prefix_hits_total":
        lambda m, b, s: m["prefix_cache"]["hits"],
    "ktwe_serving_prefix_prompt_tokens_saved_total":
        lambda m, b, s: m["prefix_cache"]["prompt_tokens_saved"],
    "ktwe_serving_prefixes_registered":
        lambda m, b, s: m["prefix_cache"]["registered"],
    "ktwe_serving_kv_blocks_free":
        lambda m, b, s: m["kv_cache"]["blocks_free"],
    "ktwe_serving_kv_blocks_used":
        lambda m, b, s: m["kv_cache"]["blocks_used"],
    "ktwe_serving_kv_blocks_shared":
        lambda m, b, s: m["kv_cache"]["blocks_shared"],
    "ktwe_serving_kv_blocks_cached":
        lambda m, b, s: m["kv_cache"]["blocks_cached"],
    "ktwe_serving_kv_evictions_total":
        lambda m, b, s: m["kv_cache"]["evictions_total"],
    "ktwe_serving_kv_admission_deferrals_total":
        lambda m, b, s: m["kv_cache"]["deferrals_total"],
    "ktwe_serving_kv_prefix_hit_rate":
        lambda m, b, s: m["kv_cache"]["prefix_hit_rate"],
    # The host KV tier under the paged pool (zeros without
    # --kv-host-blocks). blocks_used is a gauge over the host buffers;
    # offloads and prefetches count device->host and host->device block
    # copies; hits are radix misses the tier answered (each a block of
    # prefill the device never re-ran); discards are LRU evictions off the
    # floor of the hierarchy; dma_seconds accumulates transfer wall time
    # both ways.
    "ktwe_serving_kvhost_blocks_used":
        lambda m, b, s: m["kvhost"]["blocks_used"],
    "ktwe_serving_kvhost_offloads_total":
        lambda m, b, s: m["kvhost"]["offloads_total"],
    "ktwe_serving_kvhost_prefetches_total":
        lambda m, b, s: m["kvhost"]["prefetches_total"],
    "ktwe_serving_kvhost_hits_total":
        lambda m, b, s: m["kvhost"]["hits_total"],
    "ktwe_serving_kvhost_discards_total":
        lambda m, b, s: m["kvhost"]["discards_total"],
    "ktwe_serving_kvhost_corrupt_drops_total":
        lambda m, b, s: m["kvhost"]["corrupt_drops_total"],
    "ktwe_serving_kvhost_dma_failures_total":
        lambda m, b, s: m["kvhost"]["dma_failures_total"],
    "ktwe_serving_kvhost_dma_seconds_total":
        lambda m, b, s: m["kvhost"]["dma_seconds_total"],
    "ktwe_serving_resume_requests_total":
        lambda m, b, s: m["migration"]["resumed_total"],
    "ktwe_serving_resume_committed_tokens_total":
        lambda m, b, s: m["migration"]["resume_committed_tokens_total"],
    "ktwe_serving_ejected_requests_total":
        lambda m, b, s: m["migration"]["ejected_total"],
    # First-token handoffs of a prefill-role replica (a subset of ejected).
    "ktwe_serving_handoffs_total":
        lambda m, b, s: m["migration"]["handoffs_total"],
    "ktwe_serving_prefill_chunks_total":
        lambda m, b, s: m["lifetime"]["prefill_chunks"],
    "ktwe_serving_request_errors_dispatch_total":
        lambda m, b, s: m["resilience"]["errors"]["dispatch"],
    "ktwe_serving_request_errors_collect_total":
        lambda m, b, s: m["resilience"]["errors"]["collect"],
    "ktwe_serving_request_errors_commit_total":
        lambda m, b, s: m["resilience"]["errors"]["commit"],
    "ktwe_serving_request_errors_prefill_total":
        lambda m, b, s: m["resilience"]["errors"]["prefill"],
    "ktwe_serving_request_errors_watchdog_total":
        lambda m, b, s: m["resilience"]["errors"]["watchdog"],
    "ktwe_serving_request_errors_device_loss_total":
        lambda m, b, s: m["resilience"]["errors"]["device_loss"],
    # The degraded-mesh evacuation: live requests ejected as
    # reason="evacuate" resume frames on a device loss, and the degraded
    # gauge, 1 while the replica serves on one device after it (mesh.devices
    # drops with it, so the registry re-registers the replica at its
    # reduced capacity).
    "ktwe_serving_evacuated_requests_total":
        lambda m, b, s: m["resilience"]["evacuated_total"],
    "ktwe_serving_mesh_degraded": lambda m, b, s: m["mesh"]["degraded"],
    # The serving mesh (--mesh): the shape this replica spans (1/1/1 on one
    # card) and the MFU of the whole mesh (model FLOP/s over every device's
    # peak, so tp overhead lowers it). The fleet registry reads
    # mesh.devices from /v1/metrics.
    "ktwe_serving_mesh_devices": lambda m, b, s: m["mesh"]["devices"],
    "ktwe_serving_mesh_dp": lambda m, b, s: m["mesh"]["dp"],
    "ktwe_serving_mesh_tp": lambda m, b, s: m["mesh"]["tp"],
    "ktwe_serving_mesh_per_slice_mfu_pct":
        lambda m, b, s: m["mesh"]["per_slice_mfu_pct"],
    # The decode hot path: the overlap_commit gauge, host seconds on the
    # sync path (fetch, watchdog poll included), commit seconds and their
    # share that ran behind a chunk in flight, commit rounds.
    "ktwe_serving_overlap_commit":
        lambda m, b, s: 1.0 if m["hotpath"]["overlap_commit"] else 0.0,
    "ktwe_serving_fetch_sync_seconds_total":
        lambda m, b, s: m["hotpath"]["fetch_sync_s_total"],
    "ktwe_serving_commit_seconds_total":
        lambda m, b, s: m["hotpath"]["commit_s_total"],
    "ktwe_serving_commit_overlapped_seconds_total":
        lambda m, b, s: m["hotpath"]["commit_overlapped_s_total"],
    "ktwe_serving_commit_rounds_total":
        lambda m, b, s: m["hotpath"]["commit_rounds_total"],
    "ktwe_serving_watchdog_trips_total":
        lambda m, b, s: m["resilience"]["watchdog_trips"],
    "ktwe_serving_weight_swaps_total":
        lambda m, b, s: m["resilience"]["weight_swaps"],
    "ktwe_serving_weight_swap_pause_ms":
        lambda m, b, s: m["resilience"]["swap_pause_ms_last"],
    "ktwe_serving_draining":
        lambda m, b, s: 1.0 if m["resilience"]["draining"] else 0.0,
    # Tenancy: the meter's per-priority aggregates (the per-tenant
    # breakdown is in /v1/metrics' `tenancy` block), budget-exhausted
    # 429s, the queue depth by class and the batch requests preempted.
    "ktwe_serving_tenant_requests_interactive_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["interactive"][
            "requests"],
    "ktwe_serving_tenant_requests_batch_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["batch"]["requests"],
    "ktwe_serving_tenant_tokens_interactive_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["interactive"][
            "tokens"],
    "ktwe_serving_tenant_tokens_batch_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["batch"]["tokens"],
    "ktwe_serving_tenant_chip_seconds_interactive_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["interactive"][
            "chip_seconds"],
    "ktwe_serving_tenant_chip_seconds_batch_total":
        lambda m, b, s: m["tenancy"]["by_priority"]["batch"][
            "chip_seconds"],
    "ktwe_serving_tenant_budget_rejections_total":
        lambda m, b, s: m["tenancy"]["budget_rejections_total"],
    "ktwe_serving_tenants_active":
        lambda m, b, s: m["tenancy"]["active_tenants"],
    "ktwe_serving_queue_depth_interactive":
        lambda m, b, s: m["queued_interactive"],
    "ktwe_serving_queue_depth_batch":
        lambda m, b, s: m["queued_batch"],
    "ktwe_serving_preemptions_total":
        lambda m, b, s: m["migration"]["preempted_total"],
    # FaultLab injections this process has taken (all sites; the per-site
    # split is the /v1/metrics `faultlab` block). Zero without a plan.
    "ktwe_fault_injections_total":
        lambda m, b, s: faultlab.injections_total(),
    # Traffic-trace records written (--trace-out; 0 when off).
    "ktwe_serving_trace_records_total":
        lambda m, b, s: m["trace"]["records"],
    # The flight recorder: spans exported, write failures swallowed,
    # slow-request trees captured; zeros when it is off.
    "ktwe_serving_span_records_total":
        lambda m, b, s: m["spans"]["records"],
    "ktwe_serving_span_dropped_total":
        lambda m, b, s: m["spans"]["dropped"],
    "ktwe_serving_slow_requests_captured_total":
        lambda m, b, s: m["spans"]["slow_captured"],
}
# Speculative decoding (zeros with --spec-k 0): lifetime counters;
# acceptance_rate is accepted over proposed drafts, tokens_per_round the
# committed tokens a verify round, effective_k the mean dispatched draft
# length a slot-round (k_hist's total; slots riding a round without
# drafting count 0). The per-length histogram is in /v1/metrics
# (spec.k_hist).
SERVING_FAMILIES.update({
    "ktwe_serving_spec_rounds_total":
        lambda m, b, s: m["spec"]["rounds_total"],
    "ktwe_serving_spec_bypass_rounds_total":
        lambda m, b, s: m["spec"]["bypass_rounds_total"],
    "ktwe_serving_spec_tokens_total":
        lambda m, b, s: m["spec"]["tokens_total"],
    "ktwe_serving_spec_draft_proposed_total":
        lambda m, b, s: m["spec"]["draft_proposed_total"],
    "ktwe_serving_spec_draft_accepted_total":
        lambda m, b, s: m["spec"]["draft_accepted_total"],
    "ktwe_serving_spec_acceptance_rate":
        lambda m, b, s: m["spec"]["acceptance_rate"],
    "ktwe_serving_spec_tokens_per_round":
        lambda m, b, s: m["spec"]["tokens_per_round"],
    "ktwe_serving_spec_effective_k":
        lambda m, b, s: (m["spec"]["draft_proposed_total"]
                         / sum(m["spec"]["k_hist"])
                         if sum(m["spec"]["k_hist"]) else 0.0),
})
# Per-phase latency, from the same arithmetic as the span trees
# (observability/flight.py). The prefetch phase samples only requests that
# restored host-tier blocks.
for _phase in ("queue_wait", "prefetch", "prefill", "decode_per_token",
               "commit"):
    for _q in ("p50", "p95", "p99"):
        SERVING_FAMILIES[f"ktwe_serving_phase_seconds_{_phase}_{_q}"] = (
            lambda m, b, s, _p=_phase, _q=_q: m["spans"]["phase_s"][_p][_q])
del _phase, _q


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ktwe-serve-torch")
    p.add_argument("--port", type=int, help="0 = any free port")
    p.add_argument("--vocab-size", type=int)
    p.add_argument("--d-model", type=int)
    p.add_argument("--n-layers", type=int)
    p.add_argument("--n-heads", type=int)
    p.add_argument("--n-kv-heads", type=int, help="0 = same as --n-heads")
    p.add_argument("--d-ff", type=int)
    p.add_argument("--max-seq", type=int)
    p.add_argument("--checkpoint-dir", type=str,
                   help="restore trained params from a trainer "
                        "checkpoint (latest step); empty = random init")
    p.add_argument("--watch-checkpoints", type=float,
                   help="poll --checkpoint-dir every N seconds and "
                        "hot-swap weights when a new step lands "
                        "(live engine, bounded pause; 0 disables)")
    p.add_argument("--int8", action="store_true",
                   help="weight-only int8 quantization (ops/quant.py)")
    p.add_argument("--int8-kv", action="store_true",
                   help="int8 KV cache with per-row f32 scales "
                        "(models/decode.py kv_quantize)")
    p.add_argument("--num-slots", type=int)
    p.add_argument("--kv-block-len", type=int,
                   help="paged KV cache page size in tokens (must "
                        "divide --max-seq); 0 = dense per-slot cache. "
                        "Paged serving reserves only the pages a "
                        "request's prompt+maxNewTokens span needs, "
                        "radix-shares repeated prompt prefixes, and "
                        "evicts cold pages LRU — more concurrent "
                        "sequences per card at equal HBM")
    p.add_argument("--kv-num-blocks", type=int,
                   help="paged KV pool size in pages; 0 = auto "
                        "(num-slots * max-seq / kv-block-len, i.e. "
                        "equal HBM to the dense cache). Raise slots "
                        "and keep this fixed to trade per-request "
                        "headroom for density")
    p.add_argument("--kv-host-blocks", type=int,
                   help="host-RAM KV offload tier capacity in "
                        "blocks; 0 disables (requires --kv-block-len "
                        "> 0). Radix eviction demotes cold full "
                        "pages device->host over async DMA instead "
                        "of discarding, and a prompt matching an "
                        "offloaded prefix prefetches it back before "
                        "prefill — re-prefill only on a true miss "
                        "(docs/operations.md sizing runbook)")
    p.add_argument("--kv-offload-watermark", type=float,
                   help="demote-ahead trigger: when the paged pool's "
                        "free fraction drops below this, admission "
                        "evicts a couple of cold radix pages into "
                        "the host tier before allocation pressure "
                        "forces a discard; 0 disables")
    p.add_argument("--kv-gossip-interval", type=float,
                   help="seconds between prefix-digest bloom "
                        "rebuilds gossiped through /v1/metrics for "
                        "fleet-wide warm routing")
    p.add_argument("--spec-k", type=int,
                   help="speculative decoding: propose up to K draft "
                        "tokens per slot per step (self-drafting "
                        "n-gram lookup, no second model) and verify+"
                        "commit up to K+1 tokens in one dispatch. "
                        "Greedy outputs are bitwise-identical to "
                        "--spec-k 0; adaptive per-slot k falls back to "
                        "plain decode under low acceptance. 0 disables "
                        "(docs/operations.md runbook for tuning)")
    p.add_argument("--spec-ngram", type=int,
                   help="longest context n-gram the self-drafter "
                        "matches when proposing drafts (walks down "
                        "to 1); only with --spec-k > 0")
    p.add_argument("--prefill-len", type=int,
                   help="prefill CHUNK size; longer prompts prefill in "
                        "chunks up to max-seq - maxNewTokens")
    p.add_argument("--decode-chunk", type=int)
    p.add_argument("--max-queue", type=int,
                   help="waiting requests beyond this get HTTP 429")
    p.add_argument("--prefill-interleave", type=int,
                   help="max prefill chunks admitted per decode chunk while "
                        "requests are decoding")
    p.add_argument("--eos-id", type=int, help="-1 = none")
    p.add_argument("--drain-timeout", type=float,
                   help="seconds SIGTERM waits for in-flight requests")
    p.add_argument("--drain-eject-grace", type=float,
                   help="seconds after SIGTERM before live requests are "
                        "force-ejected as migrate frames (the fleet router "
                        "resumes them elsewhere); 0 = eject ~2s before "
                        "--drain-timeout")
    p.add_argument("--disagg", choices=["off", "prefill", "decode"],
                   help="disaggregated serving role: 'prefill' prefills "
                        "and lands the first token, then ejects every "
                        "request as a reason='handoff' migrate frame; "
                        "'decode' advertises this replica for the "
                        "continuations; 'off' = a mixed replica. The role "
                        "rides /v1/metrics")
    p.add_argument("--prefill-chunk-tokens", type=int,
                   help="chunked prefill: prompt slices of this many tokens "
                        "(must divide --max-seq; replaces --prefill-len) "
                        "and short decode quanta while a prefill backlog "
                        "exists; 0 disables")
    p.add_argument("--overlap-commit", type=int,
                   help="1 (default): overlapped commit pipeline — "
                        "dispatch chunk N+1 behind chunk N, then fetch "
                        "chunk N's packed tokens and run its host-side "
                        "commit work (stop/EOS/budget checks, slot frees, "
                        "stream-visible token appends) while N+1 runs; 0 "
                        "serializes the fetch and commit ahead of the next "
                        "dispatch for bisection. Transcripts are "
                        "bitwise-identical either way")
    p.add_argument("--watchdog-timeout", type=float,
                   help="fail the in-flight decode batch if no chunk "
                        "completes within this many seconds of dispatch "
                        "(hung device); 0 disables")
    p.add_argument("--temperature", type=float,
                   help="default sampling temperature (<= 0 = greedy)")
    p.add_argument("--top-k", type=int, help="top-k filter (engine-wide)")
    p.add_argument("--top-p", type=float, help="default nucleus mass")
    p.add_argument("--enable-top-p", action="store_true",
                   help="let requests pass topP even when --top-p is 1.0")
    p.add_argument("--device", type=str,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--seed", type=int, help="seed of the random init")
    p.add_argument("--auth-token", type=str,
                   help="shared bearer token required on every route but "
                        "/health (else $KTWE_AUTH_TOKEN, else the file "
                        "at $KTWE_AUTH_TOKEN_FILE; empty = no auth)")
    p.add_argument("--max-prefixes", type=int,
                   help="registered prefixes held at once (/v1/prefix); "
                        "dense: one batch-1 temp cache each")
    p.add_argument("--metrics-port", type=int,
                   help="serve the ktwe_serving_* Prometheus families on "
                        "this port (0 = off)")
    p.add_argument("--preempt-cap", type=int,
                   help="max times one batch generation may be preempted "
                        "(ejected as a reason='preempt' migrate frame for "
                        "an interactive queue head) across the fleet: the "
                        "count rides the resume state, so batch work "
                        "always finishes; 0 disables preemption")
    p.add_argument("--default-tenant", type=str,
                   help="tenant metered for requests that carry no "
                        "'tenant' field or x-ktwe-tenant header")
    p.add_argument("--tenant-budget", action="append", metavar="NAME=DOLLARS",
                   help="per-tenant budget (repeatable): once NAME's "
                        "metered spend (chip-seconds at --chip-hour-rate) "
                        "reaches DOLLARS inside the --budget-period, its "
                        "fresh requests get 429 reason=budget-exhausted "
                        "with a Retry-After to the period's end")
    p.add_argument("--budget-period",
                   choices=["daily", "weekly", "monthly", "quarterly"],
                   help="calendar period (UTC) a --tenant-budget covers; "
                        "spend resets at its end")
    p.add_argument("--chip-hour-rate", type=float,
                   help="$/chip-hour the tenant meter prices chip-seconds "
                        "at. The default, 1.20, is the JAX serve's knob "
                        "default, kept so that both replicas of a mixed "
                        "fleet price in one currency; set your fleet's "
                        "own rate")
    p.add_argument("--optimizer-url", type=str,
                   help="POST engine metrics to this optimizer base URL "
                        "(e.g. http://ktwe-optimizer:50051) every "
                        "--telemetry-interval seconds")
    p.add_argument("--telemetry-interval", type=float,
                   help="seconds between optimizer pushes (>= 1)")
    p.add_argument("--tenants", type=int,
                   help="co-tenants time-sharing this card, reported with "
                        "each optimizer push (default "
                        "$KTWE_TIMESLICE_TENANTS, else 1)")
    p.add_argument("--trace-out", type=str,
                   help="record terminal generations as an NDJSON traffic "
                        "trace (arrival time, token lengths, tenant and "
                        "priority, stream flag, resume carry; POST "
                        "/v1/admin/trace start/stop/rotate). Empty "
                        "disables capture")
    p.add_argument("--span-out", type=str,
                   help="flight recorder: write every request's phase span "
                        "tree as OTLP-shaped span NDJSON here, adopting the "
                        "router's traceparent (POST /v1/admin/spans "
                        "start/stop/rotate). Empty disables; the decode "
                        "path then runs no tracing code")
    p.add_argument("--slo-capture-threshold", type=float,
                   help="keep the span tree of any request slower than this "
                        "many seconds end to end (GET "
                        "/v1/admin/slow-requests; with or without "
                        "--span-out); 0 disables")
    p.add_argument("--mesh", type=str,
                   help="serve on a 'dp,tp' mesh of a gang (e.g. '1,4' = "
                        "4-way tensor parallel): attention heads, the MLP "
                        "hidden, the vocab and the KV cache's kv-head axis "
                        "shard over tp (Megatron; KV replicated where the "
                        "kv heads do not divide tp), dense slots over dp, "
                        "paged pools replicated over dp. The gang is one "
                        "process a rank from the launcher env "
                        "(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID); "
                        "rank 0 serves HTTP, the others run the device "
                        "programs it broadcasts. A bare N means tp=N; "
                        "empty, '1' or '1,1' = one device. Default "
                        "$KTWE_MESH")
    p.add_argument("--config", type=str, default="",
                   help="ktwe.yaml knob file: its `serve:` section sets "
                        "defaults, flags on the command line win")
    defaults = dict(DEFAULTS)
    if os.environ.get("KTWE_TIMESLICE_TENANTS") is not None:
        # The JAX knob registry's environment override of this default.
        defaults["tenants"] = int(os.environ["KTWE_TIMESLICE_TENANTS"])
    if os.environ.get("KTWE_MESH") is not None:
        defaults["mesh"] = os.environ["KTWE_MESH"]
    p.set_defaults(**defaults)
    return p


def parse_mesh_flag(value: str):
    """'dp,tp' -> (dp, tp); a bare 'N' means tp=N; '', '1' and '1,1' ->
    None (one device). ValueError on anything else (the JAX serve's
    parse)."""
    v = (value or "").strip()
    if not v:
        return None
    try:
        parts = [int(x) for x in v.split(",")]
    except ValueError:
        raise ValueError(f"--mesh must be 'dp,tp' integers, got {v!r}")
    if len(parts) == 1:
        parts = [1, parts[0]]
    if len(parts) != 2 or any(x < 1 for x in parts):
        raise ValueError(f"--mesh must be 'dp,tp' with positive "
                         f"integers, got {v!r}")
    dp, tp = parts
    return None if dp * tp == 1 else (dp, tp)


def count_weight_elements(params, cfg: Optional[tf.TransformerConfig] = None
                          ) -> int:
    """Weight elements of the served model, the 2N-FLOPs-per-token model
    behind the mesh MFU gauge: `tf.param_count` of its tree (None, a stub
    engine's, counts 0), or with `cfg` of the whole model's tree (an
    engine on a mesh holds its rank's blocks)."""
    if cfg is not None:
        return sum(int(np.prod(shape)) for shape in
                   _leaf_shapes(tf.param_shapes(cfg)))
    return tf.param_count(params) if params is not None else 0


def _leaf_shapes(tree):
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in _leaf_shapes(v)]
    return [tree]


def peak_tflops_per_device(device: torch.device) -> float:
    """Peak TFLOP/s a device behind the mesh MFU gauge: the H100's dense
    bf16 rate on the card (the trainer's MFU reads the same constant,
    train/profiling.H100_BF16_PEAK_TFLOPS); on the CPU the JAX serve's
    token 0.4, so CPU proxies stay comparable."""
    return H100_BF16_PEAK_TFLOPS if device.type == "cuda" else 0.4


class ServeService:
    """dict-in/dict-out API over the engine; one lock serializes engine
    mutation (the background step loop, request submission and the weight
    swap). `load_params` ((checkpoint_dir | None) -> (params, step))
    enables the /v1/admin/reload hot-swap. `meter` (a TenantMeter; None:
    unmetered, a zero `tenancy` block) meters every terminal view and
    gates fresh requests on its budgets; `default_tenant` is metered for
    requests that name none. `role` ("mixed", "prefill" or "decode") is
    advertised in /v1/metrics; the engine enforces the prefill role
    (handoff_first_token). `trace_writer` (a TraceWriter: --trace-out)
    records every terminal view and every refused arrival; `flight` (a
    FlightRecorder) exports a span tree per terminal view, and `span_log`
    (its JsonlExporter: --span-out) is what /v1/admin/spans drives. None
    turns each off. `mesh_shape` (dp, tp) is the mesh the engine serves on
    ((1, 1): one device), advertised with the MFU of the whole mesh in the
    /v1/metrics `mesh` block."""

    def __init__(self, engine: serving.ContinuousBatchEngine,
                 drain_timeout: float = 30.0,
                 load_params: Optional[Callable] = None,
                 meter: Optional[TenantMeter] = None,
                 default_tenant: str = "anonymous", role: str = "mixed",
                 trace_writer: Optional[TraceWriter] = None,
                 flight: Optional[FlightRecorder] = None,
                 span_log: Optional[JsonlExporter] = None,
                 mesh_shape=None):
        self._engine = engine
        self.mesh_shape = tuple(int(x) for x in (mesh_shape or (1, 1)))
        self.mesh_devices = self.mesh_shape[0] * self.mesh_shape[1]
        # 2N FLOPs a token; getattr: stub engines without a param tree.
        self._flops_per_token = 2.0 * count_weight_elements(
            getattr(engine, "params", None),
            getattr(engine, "cfg", None) if self.mesh_devices > 1 else None)
        self._peak_tflops_per_device = peak_tflops_per_device(
            getattr(engine, "device", torch.device("cpu")))
        self.role = str(role or "mixed")
        self._trace = trace_writer
        self._flight = flight
        self._span_log = span_log
        self._load_params = load_params
        self._meter = meter
        self.default_tenant = str(default_tenant)
        # The checkpoint step the engine serves (None = random init); set
        # at startup and by every reload, read by the checkpoint watcher.
        self.last_swapped_step: Optional[int] = None
        # Orders reloads only: the restore must not hold the engine lock.
        self._reload_lock = threading.Lock()
        self._drain_timeout = float(drain_timeout)
        self._drain_deadline: Optional[float] = None
        self._req_lat = LatencyWindow(capacity=512)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ktwe-serve-engine")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            active = False
            try:
                with self._lock:
                    active = self._engine.active
                    if active:
                        self._engine.step()
            except Exception as e:     # noqa: BLE001 — the loop survives
                # step() contains per-request faults, so this is an engine
                # bug; a dead loop would block every client until timeout.
                print(f"engine step escaped containment: {e!r}",
                      file=sys.stderr, flush=True)
                time.sleep(0.05)
            if not active:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
            else:
                time.sleep(0)          # let a waiting submit take the lock

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)

    def begin_drain(self) -> None:
        with self._lock:
            self._engine.drain()
        if self._drain_deadline is None:
            self._drain_deadline = time.time() + self._drain_timeout
        self._wake.set()

    def _retry_after(self, default: float, cap: float) -> float:
        """Expected seconds for pending work to clear: queue pressure times
        the observed per-request p50, spread over the slots."""
        pending = self._engine.pending
        if pending <= 0:
            return 1.0
        per_req_s = self._req_lat.snapshot()["p50_ms"] / 1e3
        if per_req_s <= 0.0:
            return max(1.0, min(default, cap))
        est = per_req_s * (1 + (pending - 1) // max(1, self._engine.num_slots))
        return max(1.0, min(est, cap))

    def wait_drained(self, timeout_s: float) -> bool:
        deadline = time.time() + float(timeout_s)
        while True:
            with self._lock:
                idle = not self._engine.active
            if idle:
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.02)

    # -- routes --

    @staticmethod
    def _view(req, traceparent: Optional[str] = None, fctx=None) -> dict:
        """The final view. An ejected request reports status "migrate"
        with its resume state, the frame a router feeds back as
        resumeFrom. With the flight recorder on it names the trace of the
        request's span tree ("traceId")."""
        status = ("cancelled" if req.cancelled
                  else "error" if req.finish_reason == "error"
                  else "migrate" if req.finish_reason == "migrated"
                  else "ok")
        out = {"status": status, "requestId": req.req_id,
               "tokens": list(req.tokens),
               "logprobs": [round(x, 6) for x in req.logprobs],
               "finishReason": req.finish_reason,
               "ttftMs": round((req.first_token_at - req.submitted_at) * 1e3,
                               3) if req.first_token_at else None}
        if req.emit_from:
            out["committedOffset"] = req.emit_from
        if req.resume_state is not None:
            out["resume"] = req.resume_state
        if req.error is not None:
            out["error"] = req.error
        if traceparent:
            out["traceparent"] = traceparent
        if fctx is not None:
            out["traceId"] = fctx.trace_id
        return out

    @staticmethod
    def _timeout_view(rid: int, req, tokens, traceparent, fctx=None) -> dict:
        out = {"status": "timeout", "requestId": rid, "tokens": tokens,
               "logprobs": [round(x, 6) for x in req.logprobs]}
        if traceparent:
            out["traceparent"] = traceparent
        if fctx is not None:
            out["traceId"] = fctx.trace_id
        return out

    def generate(self, request: dict):
        # Validate everything before touching the engine: a request
        # rejected after submit() would burn a slot. ValueError -> 400.
        eng = self._engine
        hdrs = request.get("_headers") or {}
        traceparent = hdrs.get("traceparent")
        resume = request.get("resumeFrom")
        if resume is not None and not isinstance(resume, dict):
            raise ValueError('"resumeFrom" must be a resume state object')
        # Tenancy: the body wins, then the x-ktwe-* headers, then a resume
        # carry, then the defaults.
        tenant = str(request.get("tenant") or hdrs.get("x-ktwe-tenant")
                     or (resume or {}).get("tenant") or self.default_tenant)
        priority = str(request.get("priority")
                       or hdrs.get("x-ktwe-priority")
                       or (resume or {}).get("priority") or "interactive")
        if priority not in ("interactive", "batch"):
            raise ValueError(f'priority must be "interactive" or "batch", '
                             f'got {priority!r}')
        preempted = int((resume or {}).get("preempted") or 0)
        if resume is None and self._meter is not None:
            allowed, why, reset_s = self._meter.admission(tenant)
            if not allowed:
                # Terminal for the tenant until its budget period resets,
                # unlike the queue-pressure 429 below: the reason lets the
                # fleet router pass this one through instead of retrying
                # it elsewhere.
                self._trace_rejected(
                    tenant, priority, len(request.get("prompt") or []),
                    int(request.get("maxNewTokens", 32) or 32),
                    bool(request.get("stream")), reason="budget-exhausted")
                raise StatusError(429, f"budget-exhausted: {why}",
                                  retry_after=reset_s,
                                  reason="budget-exhausted")
        if resume is not None:
            # The resume carry is the request: its prompt already holds
            # any prefix, its maxNewTokens is the original total budget.
            request = dict(request, prompt=resume["prompt"])
            request.pop("prefixId", None)
            if "maxNewTokens" in resume:
                request["maxNewTokens"] = resume["maxNewTokens"]
            for k in ("temperature", "topP", "stop", "prngKey"):
                if resume.get(k) is not None:
                    request[k] = resume[k]
        for field in _UNPORTED_FIELDS:
            if request.get(field) not in (None, []):
                raise ValueError(f'"{field}" is not served by this replica '
                                 f'yet: {_UNPORTED_FIELDS[field]}')
        prompt = [int(t) for t in request["prompt"]]
        n = int(request.get("maxNewTokens", 32))
        timeout_s = float(request.get("timeoutSeconds", 120))
        prefix_id = request.get("prefixId")
        if prefix_id is not None:
            prefix_id = int(prefix_id)
        temperature = request.get("temperature")
        if temperature is not None:
            temperature = float(temperature)
        top_p = request.get("topP")
        if top_p is not None:
            top_p = float(top_p)
            if not 0.0 < top_p <= 1.0:
                raise ValueError("topP must be in (0, 1]")
        stop = [[int(t) for t in s] for s in request.get("stop", [])]
        prng_key = request.get("prngKey")
        if prng_key is not None:
            try:
                prng_key = [int(k) for k in prng_key]
            except (TypeError, ValueError):
                prng_key = None
            if prng_key is None or len(prng_key) != 2:
                raise ValueError("prngKey must be two uint32 words")
        vocab = eng.cfg.vocab_size
        if any(not 0 <= t < vocab for t in prompt):
            raise ValueError(f"prompt token id out of range [0, {vocab})")
        if not 0 < n < eng.max_seq:
            raise ValueError(f"maxNewTokens must be in [1, {eng.max_seq})")
        if prefix_id is None and not 0 < len(prompt) <= eng.max_seq - n:
            # With a prefix, submit() checks the whole length.
            raise ValueError(f"prompt length must be in [1, {eng.max_seq - n}]"
                             f" (max-seq {eng.max_seq} - maxNewTokens {n})")
        committed = None
        if resume is not None:
            committed = [int(t) for t in resume.get("committed", [])]
            if any(not 0 <= t < vocab for t in committed):
                raise ValueError(f'"resumeFrom" committed token id out of '
                                 f'range [0, {vocab})')
            if len(committed) >= n:
                raise ValueError(
                    f'"resumeFrom" carries {len(committed)} committed '
                    f'tokens but maxNewTokens is {n}: nothing left to '
                    f'generate')
        stream = bool(request.get("stream", False))
        submitted_at = time.time()
        # The request's trace identity, fixed at arrival: the router's
        # trace when a traceparent came, else a fresh root.
        fctx = (self._flight.context(traceparent, submitted_at)
                if self._flight is not None else None)
        with self._lock:
            if prefix_id is not None and not eng.has_prefix(prefix_id):
                raise ValueError(f'"prefixId" {prefix_id} is not a '
                                 f'registered prefix')
            try:
                rid = eng.submit(prompt, n, prefix_id=prefix_id,
                                 temperature=temperature, top_p=top_p,
                                 stop=stop, committed=committed,
                                 prng_key=prng_key, tenant=tenant,
                                 priority=priority, preempted=preempted)
            except serving.QueueFull as e:
                self._trace_rejected(tenant, priority, len(prompt), n,
                                     stream, reason="queue-pressure")
                raise StatusError(429, str(e),
                                  retry_after=self._retry_after(1.0, 30.0),
                                  reason="queue-pressure")
            except serving.Draining as e:
                left = (self._drain_deadline - time.time()
                        if self._drain_deadline is not None
                        else self._drain_timeout)
                raise StatusError(503, str(e), retry_after=self._retry_after(
                    max(0.0, left), max(1.0, left)))
        self._wake.set()
        if stream:
            return self._stream_result(rid, timeout_s, submitted_at,
                                       traceparent, fctx)
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._lock:
                req = eng.result(rid)
                done = req.done
            if done:
                self._req_lat.record((time.time() - submitted_at) * 1e3)
                self._meter_record(req, submitted_at, fctx=fctx)
                return self._view(req, traceparent, fctx)
            time.sleep(0.01)
        # Deadline: cancel so the slot frees, hand back the partial tokens
        # (they ran on the card: they are metered).
        with self._lock:
            cancelled = eng.cancel(rid)
            req = eng.result(rid)
        self._meter_record(req, submitted_at, fctx=fctx)
        if not (cancelled or req.cancelled):
            return self._view(req, traceparent, fctx)  # done in the last gap
        return self._timeout_view(rid, req, list(req.tokens), traceparent,
                                  fctx)

    def _stream_result(self, rid: int, timeout_s: float, submitted_at: float,
                       traceparent: Optional[str] = None, fctx=None):
        """NDJSON generator: a {"tokens", "offset"} line per batch of new
        tokens, then the final view. A resumed request starts at its
        committed offset (those tokens are never re-emitted). A matched
        stop tail is trimmed at finish, so the last len(stop) - 1 tokens
        are held back until done. Deadline or client disconnect cancels
        the request. Every way out meters the request once, a disconnect
        included (else streaming and walking away would bypass the
        budget)."""
        deadline = time.time() + timeout_s
        metered = False
        with self._lock:
            req0 = self._engine.result(rid)
            hold = max((len(s) for s in req0.stop), default=1) - 1
            sent = req0.emit_from
        try:
            while True:
                with self._lock:
                    req = self._engine.result(rid)
                    done = req.done
                    upto = (len(req.tokens) if done
                            else max(0, len(req.tokens) - hold))
                    fresh = list(req.tokens[sent:upto])
                if fresh:
                    yield {"tokens": fresh, "offset": sent, "requestId": rid}
                    sent += len(fresh)
                if done:
                    self._req_lat.record((time.time() - submitted_at) * 1e3)
                    self._meter_record(req, submitted_at, True, fctx)
                    metered = True
                    yield self._view(req, traceparent, fctx)
                    return
                if time.time() > deadline:
                    with self._lock:
                        self._engine.cancel(rid)
                        req = self._engine.result(rid)
                    self._meter_record(req, submitted_at, True, fctx)
                    metered = True
                    yield self._timeout_view(rid, req, list(req.tokens[sent:]),
                                             traceparent, fctx)
                    return
                time.sleep(0.01)
        finally:
            with self._lock:
                try:
                    req = self._engine.result(rid)
                except KeyError:
                    req = None               # released or aged out
                if req is not None and not req.done:
                    self._engine.cancel(rid)
            if not metered and req is not None and req.done:
                # The client walked away.
                self._meter_record(req, submitted_at, True, fctx)

    def _meter_record(self, req, submitted_at: float, stream: bool = False,
                      fctx=None) -> None:
        """One terminal view: its traffic-trace record, its span tree
        (flight recorder on) and its metering: the tokens generated on
        this replica (a resume's committed tokens ran elsewhere) and the
        request's chip-seconds, its slot residency (admitted_at ->
        done_at; queue wait holds no slot) times the mesh's devices over
        the slots. A migrated view meters its tokens and residency but no
        request: one generation counts once, where it completes."""
        self._trace_record(req, submitted_at, stream)
        if self._flight is not None and fctx is not None:
            # Built after the fact from the engine's timestamps and phase
            # events: the whole cost lands here, off the decode path.
            self._flight.record(req, fctx, stream=stream)
        if self._meter is None:
            return
        resident_s = (max(0.0, req.done_at - req.admitted_at)
                      if req.admitted_at is not None and req.done_at
                      is not None else 0.0)
        self._meter.record(
            req.tenant or self.default_tenant, req.priority,
            max(0, len(req.tokens) - req.emit_from),
            resident_s * self.mesh_devices / max(1, self._engine.num_slots),
            count_request=req.finish_reason != "migrated")

    def _trace_record(self, req, submitted_at: float, stream: bool) -> None:
        """One traffic-trace record per terminal view (--trace-out; a
        record never raises). `ts` is the HTTP arrival; hops the carried
        preempt count. TTFT comes from the engine's own perf_counter pair,
        never the HTTP wall clock."""
        if self._trace is None:
            return
        status = ("cancelled" if req.cancelled
                  else "error" if req.finish_reason == "error"
                  else "migrate" if req.finish_reason == "migrated"
                  else "ok")
        self._trace.record({
            "kind": "generation",
            "ts": round(submitted_at, 6),
            "tenant": req.tenant or self.default_tenant,
            "priority": req.priority,
            "prompt_tokens": len(req.prompt),
            "max_new": int(req.max_new_tokens),
            "output_tokens": len(req.tokens),
            "stream": bool(stream),
            "resume": req.emit_from > 0,
            "committed": req.emit_from,
            "hops": int(req.preempted),
            "status": status,
            "ttft_ms": (round((req.first_token_at - req.submitted_at) * 1e3,
                              3) if req.first_token_at else None),
        })

    def _trace_rejected(self, tenant: str, priority: str, prompt_len: int,
                        max_new: int, stream: bool, reason: str) -> None:
        """Trace a refused arrival (a queue-pressure or budget 429): a
        storm trace without its shed peak would tune against milder load
        than production saw."""
        if self._trace is None:
            return
        self._trace.record({
            "kind": "generation",
            "ts": round(time.time(), 6),
            "tenant": tenant,
            "priority": priority,
            "prompt_tokens": int(prompt_len),
            "max_new": int(max_new),
            "output_tokens": 0,
            "stream": bool(stream),
            "resume": False,
            "hops": 0,
            "status": "rejected",
            "reason": reason,
        })

    def admin_trace(self, request: dict) -> dict:
        """POST /v1/admin/trace: start/stop/rotate/status of the
        --trace-out capture; 400 without it."""
        return admin_trace(self._trace, request)

    def admin_spans(self, request: dict) -> dict:
        """POST /v1/admin/spans: start/stop/rotate/status of the
        --span-out span log; 400 without it."""
        return admin_spans(self._span_log, request)

    def slow_requests(self, _request: dict) -> dict:
        """GET /v1/admin/slow-requests: the span trees of the recent
        requests over --slo-capture-threshold, most recent last; 400 when
        the flight recorder is off."""
        if self._flight is None:
            raise ValueError(
                "flight recorder is not configured (start with "
                "--span-out and/or --slo-capture-threshold)")
        return {"status": "ok", "slow": self._flight.slow_list()}

    def _trace_metrics(self) -> dict:
        """The /v1/metrics `trace` block; zeros without --trace-out."""
        if self._trace is None:
            return {"enabled": 0, "records": 0, "dropped": 0,
                    "rotations": 0}
        return {"enabled": int(self._trace.enabled),
                "records": self._trace.records_total,
                "dropped": self._trace.dropped_total,
                "rotations": self._trace.rotations_total}

    def result(self, request: dict) -> dict:
        """POST or GET /v1/result {"requestId"}: the final view, or
        {"status": "pending", "tokensSoFar"} while it runs; 404 for an
        unknown (or aged-out) id."""
        rid = int(request.get("requestId", request.get("id", -1)))
        traceparent = (request.get("_headers") or {}).get("traceparent")
        with self._lock:
            try:
                req = self._engine.result(rid)
            except KeyError:
                raise StatusError(404, f"unknown request id {rid}")
            if not req.done:
                return {"status": "pending", "requestId": rid,
                        "tokensSoFar": len(req.tokens)}
        return self._view(req, traceparent)

    def cancel(self, request: dict) -> dict:
        """POST /v1/cancel {"requestId"}: evict it wherever it is."""
        rid = int(request["requestId"])
        with self._lock:
            try:
                cancelled = self._engine.cancel(rid)
            except KeyError:
                raise StatusError(404, f"unknown request id {rid}")
        return {"status": "ok", "requestId": rid, "cancelled": cancelled}

    def prefix(self, request: dict) -> dict:
        """POST /v1/prefix: register {"tokens": [ids]} (-> prefixId and
        cachedTokens) or release {"releaseId": id}. A full registry is a
        429 without Retry-After (only a release clears it); a paged pool
        that cannot hold the prefix a 429 with one."""
        if "tokens" in request:
            tokens = [int(t) for t in request["tokens"]]
            vocab = self._engine.cfg.vocab_size
            if any(not 0 <= t < vocab for t in tokens):
                # A clamped gather would pin wrong KV for every borrower.
                raise ValueError(f"prefix token id out of range [0, {vocab})")
            with self._lock:
                try:
                    pid = self._engine.register_prefix(tokens)
                except serving.QueueFull as e:
                    raise StatusError(
                        429, str(e), retry_after=self._retry_after(1.0, 30.0)
                        if e.retryable else None)
                cached = self._engine.prefix_cached_len(pid)
            return {"status": "ok", "prefixId": pid, "cachedTokens": cached}
        rid = int(request["releaseId"])
        with self._lock:
            try:
                self._engine.release_prefix(rid)
            except KeyError:
                raise StatusError(404, f"unknown prefix id {rid}")
        return {"status": "ok", "released": rid}

    def kvhost(self, request: dict) -> dict:
        """POST /v1/kvhost: {"digests": [...]} exports the host tier's
        blocks of those digests (absent ones are skipped: the peer
        re-prefills that tail); {"entries": [...]} installs a peer's blocks
        (another signature's or a corrupt payload is rejected inside the
        tier and not counted). Best effort both ways: a failed ship
        degrades to a re-prefill."""
        if "digests" in request:
            digests = [str(d) for d in request["digests"]]
            with self._lock:
                entries = self._engine.kvhost_export(digests)
            return {"status": "ok", "entries": entries}
        if "entries" in request:
            payloads = [dict(p) for p in request["entries"]]
            with self._lock:
                accepted = self._engine.kvhost_import(payloads)
            return {"status": "ok", "imported": int(accepted)}
        raise ValueError('kvhost request needs "digests" or "entries"')

    def eject(self, _request: dict) -> dict:
        """POST /v1/admin/eject: every live request leaves as a resume
        state; streams end with a migrate frame, blocking callers get the
        migrate view. The autoscaler calls it when a drain's deadline
        passes, the SIGTERM drain through eject_live()."""
        with self._lock:
            states = self._engine.eject_live()
        self._wake.set()
        return {"status": "ok", "ejected": len(states),
                "requestIds": [s["requestId"] for s in states]}

    def eject_live(self) -> int:
        return int(self.eject({})["ejected"])

    def reload(self, request: dict) -> dict:
        """POST /v1/admin/reload {"checkpointDir"?: str}: live weight
        hot-swap. The checkpoint restore runs outside the engine lock; only
        swap_params' bounded pause holds it, between steps. A tree that
        does not match the engine's -> 409 and the old weights keep
        serving."""
        if self._load_params is None:
            raise StatusError(
                503, "no checkpoint source (start with --checkpoint-dir)")
        ckpt_dir = request.get("checkpointDir") or None
        with self._reload_lock:
            try:
                new_params, step = self._load_params(ckpt_dir)
            except FileNotFoundError as e:
                raise StatusError(404, f"checkpoint restore failed: {e}")
            except Exception as e:   # noqa: BLE001 — a half-written or
                # incompatible checkpoint is the documented 409 (old weights
                # keep serving), not a dropped connection.
                raise StatusError(409, f"checkpoint restore failed: {e!r}")
            with self._lock:
                try:
                    pause_ms = self._engine.swap_params(new_params)
                except ValueError as e:
                    raise StatusError(409, str(e))
                except Exception as e:   # noqa: BLE001 — swap_params
                    # commits only after every copy landed, so the engine
                    # is still on the old weights.
                    raise StatusError(
                        500, f"hot-swap failed (engine still on old "
                             f"weights): {e!r}")
            # Inside the reload lock: two reloads finishing out of order
            # must not record the older step.
            self.last_swapped_step = step
        print(f"weights hot-swapped to step {step} "
              f"(pause {pause_ms:.3f} ms)", flush=True)
        return {"status": "ok", "step": step,
                "swapPauseMs": round(pause_ms, 3)}

    def health(self, _request: dict) -> dict:
        """200 while serving; 503 "draining" once the drain begins."""
        if self._engine.draining:
            raise StatusError(503, "draining")
        return {"status": "ok"}

    def _metrics(self):
        """(the /v1/metrics dict, slots_busy, num_slots); only the
        snapshot runs under the lock, the percentile sorts after it."""
        with self._lock:
            snap = self._engine.metrics_snapshot()
            busy = self._engine.slots_busy
        m = serving.ContinuousBatchEngine.aggregate_metrics(snap)
        m["slots_busy"] = busy
        m["slots"] = self._engine.num_slots
        m["request_lat_ms"] = self._req_lat.snapshot()
        m["role"] = self.role
        m["device"] = str(self._engine.device)
        # The mesh's shape and MFU: the registry's mesh.devices source.
        m["mesh"] = self._mesh_metrics(m)
        m["tenancy"] = self._tenancy_metrics()
        m["trace"] = self._trace_metrics()
        # The flight recorder's counters and phase windows (zeros when it
        # is off, so the families stay alive).
        m["spans"] = (self._flight.metrics() if self._flight is not None
                      else zero_metrics())
        # FaultLab's per-site injections (the Prometheus family is the
        # total).
        m["faultlab"] = faultlab.snapshot()
        return m, busy, self._engine.num_slots

    def _mesh_metrics(self, m: dict) -> dict:
        """The /v1/metrics `mesh` block (the JAX serve's): the shape, and
        achieved model FLOP/s (2N a token times the tokens/s) over the
        whole mesh's peak, so tp overhead lowers it. After a device loss
        the engine serves on one device: the advertised capacity shrinks
        with it (devices 1, shape "degraded")."""
        dp, tp = self.mesh_shape
        degraded = bool(m.get("resilience", {}).get("mesh_degraded"))
        devices = 1 if degraded else self.mesh_devices
        mfu = (100.0 * m.get("aggregate_tokens_per_s", 0.0)
               * self._flops_per_token
               / (devices * self._peak_tflops_per_device * 1e12))
        # 8 decimals: a small CPU model's MFU is ~1e-5 % and must not
        # round to a dead gauge.
        return {"devices": devices,
                "dp": 1 if degraded else dp,
                "tp": 1 if degraded else tp,
                "shape": "degraded" if degraded else f"dp={dp},tp={tp}",
                "degraded": int(degraded),
                "per_slice_mfu_pct": round(mfu, 8)}

    def _tenancy_metrics(self) -> dict:
        """The /v1/metrics `tenancy` block: the meter's per-priority
        aggregates and per-tenant breakdown; zeros when unmetered, so the
        families stay alive."""
        if self._meter is not None:
            return self._meter.snapshot()
        zero = {"requests": 0, "tokens": 0, "chip_seconds": 0.0}
        return {"active_tenants": 0, "budget_rejections_total": 0,
                "by_priority": {"interactive": dict(zero),
                                "batch": dict(zero)},
                "tenants": {}}

    def metrics(self, _request: dict) -> dict:
        return {"status": "ok", "metrics": self._metrics()[0]}

    def prometheus_series(self) -> dict:
        """The SERVING_FAMILIES values for a --metrics-port scrape."""
        m, busy, slots = self._metrics()
        return {name: float(src(m, busy, slots))
                for name, src in SERVING_FAMILIES.items()}


def make_handler(service: ServeService, auth_token: str = ""):
    """The HTTP handler serving `service`'s routes (the JAX serve's, but
    /v1/kvhost)."""
    return make_json_handler(
        {"/v1/generate": service.generate, "/v1/result": service.result,
         "/v1/cancel": service.cancel, "/v1/metrics": service.metrics,
         "/v1/prefix": service.prefix, "/v1/kvhost": service.kvhost,
         "/v1/admin/reload": service.reload,
         "/v1/admin/eject": service.eject,
         "/v1/admin/trace": service.admin_trace,
         "/v1/admin/spans": service.admin_spans},
        get_routes={"/v1/result": service.result,
                    "/v1/metrics": service.metrics,
                    "/v1/admin/slow-requests": service.slow_requests,
                    "/health": service.health},
        auth_token=auth_token)


def push_serving_telemetry(metrics: dict, client, bucket: str,
                           tenants: int, slots: int) -> bool:
    """One density point to the optimizer through an HTTPOptimizerClient
    (bearer token, failure backoff, never raises). False when there is
    nothing to report or the push failed."""
    if metrics.get("tokens", 0) <= 0 or metrics["token_lat_p99_ms"] <= 0:
        return False
    resp = client.ingest_serving_telemetry({
        "bucket": bucket,
        "tokens_per_s": metrics["aggregate_tokens_per_s"],
        "token_p99_ms": metrics["token_lat_p99_ms"],
        "slots": slots, "tenants": tenants,
    })
    return resp.get("status") == "ok"


def telemetry_bucket(args) -> str:
    """The optimizer's model bucket of this serve, as the JAX serve names
    it: d{d}-L{L}-ff{ff}-V{V}|{int8|bf16}."""
    return (f"d{args.d_model}-L{args.n_layers}-ff{args.d_ff}"
            f"-V{args.vocab_size}|{'int8' if args.int8 else 'bf16'}")


def telemetry_loop(service: ServeService, client, bucket: str, tenants: int,
                   slots: int, interval_s: float,
                   stop: threading.Event) -> None:
    """Push a density point every `interval_s` seconds until `stop`."""
    while not stop.wait(interval_s):
        push_serving_telemetry(service.metrics({})["metrics"], client,
                               bucket, tenants, slots)


def build_flight(args):
    """(FlightRecorder, JsonlExporter) that `args` describe, or
    (None, None) when neither --span-out nor --slo-capture-threshold asks
    for the recorder. The slow-request ring wraps the span log (or, without
    --span-out, an in-memory exporter)."""
    if not (args.span_out or args.slo_capture_threshold > 0):
        return None, None
    span_log = JsonlExporter(args.span_out) if args.span_out else None
    capture = SlowRequestCapture(
        span_log if span_log is not None
        else InMemoryExporter(capacity=1024),
        threshold_s=args.slo_capture_threshold,
        root_names=(ROOT_SPAN_REPLICA,))
    return FlightRecorder(Tracer("ktwe-serve", capture),
                          capture=capture), span_log


def _finish_leaf(name: str, leaf: torch.Tensor, cfg: tf.TransformerConfig,
                 int8: bool, device: Optional[torch.device] = None,
                 mesh=None):
    """One leaf of any param source, finished: moved to `device` (when
    given), its f32 cast to the serve dtype, a matmul weight optionally
    weight-only int8, and on a serving mesh cut to this rank's block."""
    if device is not None:
        leaf = leaf.to(device)
    if leaf.dtype == torch.float32:
        leaf = leaf.to(cfg.dtype)
    if int8:
        leaf = quantize_leaf(name, leaf)
    if mesh is not None:
        leaf = decode.shard_params_for_serving({name: leaf}, cfg, mesh)[name]
    return leaf


def _finish_params(params, cfg: tf.TransformerConfig, int8: bool,
                   device: Optional[torch.device] = None, mesh=None):
    """The conditioning every param source goes through (random init,
    checkpoint, reload), leaf by leaf (`_finish_leaf`): each leaf is
    finished before the next moves, so the card holds at most one full
    leaf beyond the served tree (on a mesh: beyond the rank's blocks).
    The cast and the int8 quantization are exact per-element steps and an
    amax, so they give the same bits on the host as on the card."""
    def walk(tree):
        return {k: (walk(v) if isinstance(v, dict) else
                    _finish_leaf(k, v, cfg, int8, device, mesh))
                for k, v in tree.items()}
    return walk(params)


def _check_shapes(tree, shapes, path: str = "") -> None:
    """ValueError unless `tree` has the structure and leaf shapes of
    `shapes` (tf.param_shapes of the served config)."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            raise ValueError(f"checkpoint param tree at {path or 'root'} "
                             f"does not match the served config")
        for k in shapes:
            _check_shapes(tree[k], shapes[k], f"{path}/{k}")
        return
    if tuple(tree.shape) != tuple(shapes):
        raise ValueError(f"checkpoint param {path} has shape "
                         f"{tuple(tree.shape)}, the served config wants "
                         f"{tuple(shapes)}")


def make_params_loader(cfg: tf.TransformerConfig, default_dir: str,
                       int8: bool, device: torch.device) -> Callable:
    """(checkpoint_dir | None) -> (finished params on `device`, step): the
    load shared by startup, POST /v1/admin/reload and the
    --watch-checkpoints poller. Only the params are read (memory-mapped,
    the Adam moments never leave the file), checked against the served
    config on the host, then moved leaf by leaf through _finish_params."""
    def load(ckpt_dir: Optional[str] = None):
        directory = ckpt_dir or default_dir
        if not directory:
            raise FileNotFoundError("no checkpoint directory configured")
        if not os.path.isdir(directory):
            raise FileNotFoundError(f"no checkpoint directory {directory}")
        host, step = CheckpointManager(directory).load_params()
        _check_shapes(host, tf.param_shapes(cfg))
        return _finish_params(host, cfg, int8, device), step
    return load


def serve_config(args, device: torch.device) -> tf.TransformerConfig:
    """The model `args` describe, in bf16 on the card and f32 on the CPU."""
    return tf.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads or args.n_heads, d_ff=args.d_ff,
        max_seq=args.max_seq, kv_cache_int8=args.int8_kv,
        dtype=torch.bfloat16 if device.type == "cuda" else torch.float32)


def build_engine(args, mesh=None) -> serving.ContinuousBatchEngine:
    """The engine `args` describe, on a seeded random init, each leaf
    finished as it is drawn (every rank of a gang draws the same leaves and
    keeps its blocks, one full leaf at a time)."""
    device = resolve_device(args.device)
    cfg = serve_config(args, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    return make_engine(args, tf.init_params(gen, cfg, finish=(
        lambda name, t: _finish_leaf(name, t, cfg, args.int8, mesh=mesh))),
        mesh)


def make_engine(args, params, mesh=None) -> serving.ContinuousBatchEngine:
    """The engine `args` describe, on `params`: finished and on the device,
    on a serving mesh this rank's blocks
    (models/decode.shard_params_for_serving)."""
    device = resolve_device(args.device)
    cfg = serve_config(args, device)
    return serving.ContinuousBatchEngine(
        params, cfg, num_slots=args.num_slots,
        max_seq=args.max_seq, prefill_len=args.prefill_len,
        decode_chunk=args.decode_chunk, max_queue=args.max_queue,
        prefill_interleave=args.prefill_interleave,
        eos_id=None if args.eos_id < 0 else args.eos_id,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        enable_top_p=True if args.enable_top_p else None, seed=args.seed,
        kv_block_len=args.kv_block_len, kv_num_blocks=args.kv_num_blocks,
        max_prefixes=args.max_prefixes,
        overlap_commit=bool(args.overlap_commit),
        watchdog_timeout=args.watchdog_timeout or None,
        preempt_cap=args.preempt_cap,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        handoff_first_token=args.disagg == "prefill",
        record_phase_events=bool(args.span_out
                                 or args.slo_capture_threshold > 0),
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        kv_host_blocks=args.kv_host_blocks,
        kv_offload_watermark=args.kv_offload_watermark,
        kv_gossip_interval=args.kv_gossip_interval, mesh=mesh,
        device=device)


def eject_grace_s(drain_timeout: float, drain_eject_grace: float) -> float:
    """Seconds after SIGTERM at which live requests are ejected: the
    eject and the migrate frames' flush land inside the drain budget, so
    up to 2 s of it (at most half) is kept for them, and a grace is never
    later than that."""
    flush_reserve = min(2.0, drain_timeout / 2)
    latest = max(0.5, drain_timeout - flush_reserve)
    return (min(drain_eject_grace, latest) if drain_eject_grace > 0
            else latest)


def build_meter(args, parser: argparse.ArgumentParser) -> TenantMeter:
    """The tenant meter `args` describe. It always runs (the tenant
    families exist on every deployment); a budget engine joins only with
    --tenant-budget, one BLOCK budget a NAME=DOLLARS."""
    cost_engine = None
    if args.tenant_budget:
        cost_engine = CostEngine()
        period = BudgetPeriod(args.budget_period.capitalize())
        for spec in args.tenant_budget:
            name, sep, limit = str(spec).partition("=")
            if not sep or not name:
                parser.error(f"--tenant-budget must be NAME=DOLLARS, got "
                             f"{spec!r}")
            try:
                dollars = float(limit)
            except ValueError:
                parser.error(f"--tenant-budget {spec!r}: DOLLARS must be a "
                             f"number")
            cost_engine.create_budget(
                f"tenant-{name}", dollars, BudgetScope.TENANT,
                scope_value=name, period=period,
                enforcement=EnforcementPolicy.BLOCK)
            print(f"tenant budget: {name} = ${dollars:.2f}/"
                  f"{args.budget_period}", flush=True)
    return TenantMeter(engine=cost_engine,
                       chip_hour_rate=args.chip_hour_rate)


def watch_checkpoints(service: ServeService, directory: str,
                      interval_s: float, stop: threading.Event) -> None:
    """Poll `directory` every `interval_s` seconds; when its latest step
    is not the one the engine serves, hot-swap it through the reload path.
    A failure (a half-written or mismatched checkpoint) is printed and
    retried next tick; the engine keeps serving the old weights."""
    mgr = CheckpointManager(directory)
    while not stop.wait(interval_s):
        try:
            mgr.refresh()
            latest = mgr.latest_step()
            if latest is None or latest == service.last_swapped_step:
                continue
            service.reload({})
        except Exception as e:   # noqa: BLE001 — the poller survives
            print(f"checkpoint watch failed: {e!r}", file=sys.stderr,
                  flush=True)


def check_mesh(args, parser: argparse.ArgumentParser, num_processes: int):
    """The --mesh flag's (dp, tp) (None: one device), its errors in flag
    language before the model loads (exit 2, the JAX serve's wording;
    devices are the gang's processes, one device a process)."""
    try:
        mesh_shape = parse_mesh_flag(args.mesh)
    except ValueError as e:
        parser.error(str(e))
    if mesh_shape is None:
        if num_processes > 1:
            parser.error(f"a gang of {num_processes} processes "
                         f"(NUM_PROCESSES) serves on a --mesh of "
                         f"{num_processes} devices")
        return None
    dp, tp = mesh_shape
    if num_processes != dp * tp:
        parser.error(f"--mesh {args.mesh} needs {dp * tp} devices; this "
                     f"gang has {num_processes} (NUM_PROCESSES, one device "
                     f"a process)")
    for dim, value in (("--n-heads", args.n_heads), ("--d-ff", args.d_ff),
                       ("--vocab-size", args.vocab_size)):
        if value % tp:
            parser.error(f"--mesh tp={tp} must divide {dim} ({value}) — "
                         f"the Megatron split shards that axis with no "
                         f"replicate fallback")
    if not args.kv_block_len and args.num_slots % dp:
        parser.error(f"--mesh dp={dp} must divide --num-slots "
                     f"({args.num_slots}) — the dense KV cache's slot axis "
                     f"shards over dp (paged engines via --kv-block-len "
                     f"have no such constraint)")
    return mesh_shape


def main(argv=None, *, stop: Optional[threading.Event] = None,
         on_ready: Optional[Callable[[int], None]] = None) -> int:
    """Serve until SIGTERM/SIGINT (or until `stop` is set, for a caller
    that runs the server in a thread; `on_ready` then gets the bound
    port), drain, exit 0. With --mesh the process is one rank of a gang
    (the launcher env): rank 0 serves, the others run the programs it
    broadcasts and exit 0 when it stops them."""
    parser = build_parser()
    args = parse_with_config(parser, "serve", argv)
    mesh_shape = check_mesh(args, parser,
                            int(os.environ.get("NUM_PROCESSES", "1")))
    if args.kv_num_blocks and not args.kv_block_len:
        # A pool size without a page size would silently build the dense
        # engine; fail fast instead.
        parser.error("--kv-num-blocks requires --kv-block-len > 0")
    if args.kv_host_blocks and not args.kv_block_len:
        # The host tier stores paged blocks; without paging there is
        # nothing block-shaped to demote.
        parser.error("--kv-host-blocks requires --kv-block-len > 0")
    if args.spec_k and args.int8_kv:
        # The engine raises the same constraint at construction; say it in
        # flag language before the model loads.
        parser.error("--spec-k does not support --int8-kv yet (the "
                     "verify program carries no KV scale rows)")
    if args.prefill_chunk_tokens:
        if args.max_seq % args.prefill_chunk_tokens:
            parser.error(f"--prefill-chunk-tokens "
                         f"{args.prefill_chunk_tokens} must divide "
                         f"--max-seq {args.max_seq} (it is the prefill "
                         f"slice grid)")
        if args.disagg == "prefill":
            # A prefill replica never decodes: there is no decode tail to
            # protect.
            parser.error("--prefill-chunk-tokens is the single-replica "
                         "complement of disaggregation; a --disagg "
                         "prefill replica has no decode to interleave "
                         "with")
    if args.telemetry_interval < 1.0:
        # The JAX knob registry's lower bound of this knob.
        parser.error(f"--telemetry-interval {args.telemetry_interval} is "
                     f"below 1.0")
    # FaultLab's replay entry point: KTWE_FAULT_SEED=N activates the plan
    # a failing run printed (inert without it).
    fault_plan = faultlab.from_env()
    if fault_plan is not None:
        faultlab.activate(fault_plan)
        print(f"[faultlab] ACTIVE: {fault_plan!r}", flush=True)
    auth_token = resolve_auth_token(args.auth_token)
    meter = build_meter(args, parser)
    gang, mesh = None, None
    if mesh_shape is not None:
        gang, mesh = bootstrap.initialize_serving(mesh_shape,
                                                  device=args.device)
    device = resolve_device(args.device)
    cfg = serve_config(args, device)
    # On a mesh a checkpoint is finished on the host: only each rank's
    # blocks reach its card, and a reload's full tree stays on the host.
    loader = make_params_loader(cfg, args.checkpoint_dir, args.int8,
                                device if mesh is None
                                else torch.device("cpu"))
    ckpt_step = None
    if args.checkpoint_dir:
        params, ckpt_step = loader()
        print(f"restored params from step {ckpt_step}", flush=True)
        if mesh is not None:
            params = decode.shard_params_for_serving(params, cfg, mesh,
                                                     device)
        engine = make_engine(args, params, mesh)
        del params
    else:
        engine = build_engine(args, mesh)
    if mesh is not None:
        print(f"serving mesh {mesh.describe()} ({mesh.size} devices), rank "
              f"{mesh.rank}", flush=True)
        if not mesh.is_driver:
            if threading.current_thread() is threading.main_thread():
                # A follower ends when the driver stops the gang (its drain
                # is the gang's), not on its own signal.
                signal.signal(signal.SIGTERM, signal.SIG_IGN)
                signal.signal(signal.SIGINT, signal.SIG_IGN)
            try:
                engine.follow()
            finally:
                gang.close()
            print(f"rank {mesh.rank} stopped", flush=True)
            return 0
    # Traffic-trace capture and the flight recorder, each off unless asked.
    trace_writer = TraceWriter(args.trace_out) if args.trace_out else None
    flight, span_log = build_flight(args)
    if flight is not None:
        print(f"flight recorder on (span-out="
              f"{args.span_out or '<memory>'}, slo-capture-threshold="
              f"{args.slo_capture_threshold}s)", flush=True)
    service = ServeService(engine, drain_timeout=args.drain_timeout,
                           load_params=loader if args.checkpoint_dir
                           else None, meter=meter,
                           default_tenant=args.default_tenant,
                           role="mixed" if args.disagg == "off"
                           else args.disagg, trace_writer=trace_writer,
                           flight=flight, span_log=span_log,
                           mesh_shape=mesh_shape)
    service.last_swapped_step = ckpt_step
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(service, auth_token))
    http_thread = threading.Thread(target=server.serve_forever, daemon=True,
                                   name="ktwe-serve-http")
    http_thread.start()
    port = server.server_address[1]
    print(f"ktwe-serve-torch up on :{port} ({engine.device})", flush=True)
    metrics_srv = None
    if args.metrics_port:
        metrics_srv = ProcMetricsServer(extra=service.prometheus_series)
        metrics_srv.start(args.metrics_port)
        print(f"ktwe-serve-torch metrics on :{metrics_srv.port}", flush=True)
    if stop is None:
        stop = threading.Event()
        signal.signal(signal.SIGTERM, lambda *a: stop.set())
        signal.signal(signal.SIGINT, lambda *a: stop.set())
    workers = []
    if args.watch_checkpoints > 0 and args.checkpoint_dir:
        workers.append(threading.Thread(
            target=watch_checkpoints, args=(service, args.checkpoint_dir,
                                            args.watch_checkpoints, stop),
            daemon=True, name="ktwe-serve-ckpt-watch"))
    if args.optimizer_url:
        # The serve's own bearer token: an optimizer deployed with auth
        # would otherwise answer every push 401.
        client = HTTPOptimizerClient(args.optimizer_url,
                                     auth_token=auth_token)
        workers.append(threading.Thread(
            target=telemetry_loop, args=(
                service, client, telemetry_bucket(args), args.tenants,
                args.num_slots, args.telemetry_interval, stop),
            daemon=True, name="ktwe-serve-telemetry"))
    for worker in workers:
        worker.start()
    if on_ready is not None:
        on_ready(port)
    try:
        stop.wait()
    finally:
        if workers:
            stop.set()
            for worker in workers:
                worker.join()
        service.begin_drain()
        print(f"draining: waiting up to {args.drain_timeout}s for in-flight "
              f"requests", flush=True)
        flush_reserve = min(2.0, args.drain_timeout / 2)
        if service.wait_drained(eject_grace_s(args.drain_timeout,
                                              args.drain_eject_grace)):
            time.sleep(0.25)     # let blocking pollers read their results
            print("drain complete", flush=True)
        else:
            n = service.eject_live()
            print(f"drain grace expired; ejected {n} live requests as "
                  f"migrate frames", flush=True)
            service.wait_drained(max(0.5, flush_reserve - 0.5))
            time.sleep(0.5)      # let streams flush their migrate frames
        service.stop()
        # The followers leave their loop; the gang's group is left.
        engine.stop_followers()
        if gang is not None:
            gang.close()
        if trace_writer is not None:
            trace_writer.close()
        if span_log is not None:
            span_log.close()
        if metrics_srv is not None:
            metrics_srv.stop()
        server.shutdown()
        server.server_close()
        http_thread.join()   # its bound serve_forever holds the server
    return 0


if __name__ == "__main__":
    sys.exit(main())
