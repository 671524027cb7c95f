"""Smoke run of the PyTorch port on one NVIDIA card (H100).

Drives the port's serving path at the default serve dims (vocab 32768,
d_model 2048, 3 layers, 4 heads of 512, d_ff 16384, max_seq 256, 8 slots,
prefill_len 128, decode_chunk 8), its training path at the trainer's
defaults (vocab 32768, d_model 2048, 8 layers, 16 heads of 128, d_ff 8192,
seq 2048, batch 8) and at the flagship training configuration
(train/flagship.py: 3 layers, 4 heads of 512, d_ff 16384, seq 2048,
single-chunk fused LM-head CE, microbatches of 8), from seeded random
inits in bf16:

  1. prints the card's name and power limit (nvidia-smi) and builds every
     kernel from csrc/, one nvcc per source, all at once;
  2. holds each kernel against its plain PyTorch version on the card at the
     shapes the serving, training and flagship paths give it (and small
     ragged shapes, bf16 and f32), and times on the device (calls captured in one
     CUDA graph, replayed) the kernel, the plain version and, where one
     PyTorch call computes the same function, that call (for the RMSNorm
     backward the op F.rms_norm's backward runs,
     aten._fused_rms_norm_backward, timed as the kernels are, and also
     torch.autograd.grad of F.rms_norm, eager; for the attention backward
     torch.autograd.grad of scaled_dot_product_attention on a retained
     graph, eager, between CUDA events; for the fused CE, the head matmul
     plus F.cross_entropy, two calls, and their backward to the hidden);
     at the trainer's rows also what the card's memory gives for the
     RMSNorm's bytes through one call (`copy_`, `torch.add`); the
     wrapper's eager per-call rate, which includes the host's cost of
     issuing it, is reported apart. The paged decode kernel is also timed
     beside `scaled_dot_product_attention` over the same rows laid out as a
     contiguous cache (`dense_sdpa_ms`, a yardstick: that call does no
     table walk, so it is not the same function). The embedding gather is
     timed beside `F.embedding` (the gather alone) and the eager
     `table.to(dtype)[ids] * scale` it replaced (`eager_ms`), the relayouts
     beside `x.transpose(1, 2).contiguous()`. The RoPE kernels read the
     cos/sin views of the (max_seq, D/2, 2) frequency table in place, as the
     main paths hand them over, and are held bit for bit, the rotation and
     its VJP alike; RoPE is also run as a prefill chunk calls it
     (`attention.apply_rope` on the table, forward and VJP), each call's
     kernel launches counted by torch.profiler (one each way, else the run
     fails). The launch floor, a one-element `zero_()` timed as the kernels
     are, is printed on the kernels line. Shapes no main path gives
     are held to the plain versions too: RMSNorm rows past the
     register-resident layouts, flash forward and backward at head_dim 12
     and 640, paged decode at 32 query heads a kv head and head_dim 1024;
     the paged decode call (split-KV kernel and combine) is also checked
     for bitwise repeats, and its combine kernel alone on the split
     kernel's partials;
  3. runs the main paths, each with the launch counters set to 0 just
     before it and read just after: the dense engine on 8 requests of
     128-token prompts plus one of 160 (chunked prefill at offset 128); the
     serve main in-process answering three POST /v1/generate (one
     streamed); the paged engine (kv_block_len 16) on 8 requests of 160
     tokens sharing a 128-token prefix plus one cold request of 160, after
     a warm-up that published the prefix, so 8 of the 9 start from pool
     pages; the paged serve main answering two requests that share a
     128-token prefix; the checkpoint phase (the trainer main at the serve
     dims, seq 256, batch 8, on a token shard written from a seed: 3 steps
     straight against 2, a save and a resumed third step, held bit for
     bit in loss, grad norm, params, both Adam moments, count and step; a
     SIGTERM drain that leaves the drained step's checkpoint and
     drain-complete.json; the dense and the paged serve main from
     --checkpoint-dir answering greedy requests exactly as an in-process
     engine on the same checkpoint, a /v1/admin/reload to a later step
     answering as the new weights, one of another model's checkpoint
     answering 409 and changing nothing, no page leaked; it prints the
     checkpoint's bytes, save and restore seconds, the serve load's peak
     device memory, the swap pause and the step ms on the shard against
     synthetic data; checkpoints live in a temporary directory, at most
     two full ones at a time; since the fleet slice the dense and paged
     serve mains also register a 160-token prefix before the reload, a
     prefixId request answers as the full prompt on the new weights, and
     the reload is repeated without the prefix: the swap pause with and
     without one); the fleet phase, once dense and once paged: two serve
     mains A and B on the same seeded weights, each with a --metrics-port
     (a 160-token prefix registered on A, 8 requests of it plus 32 tokens
     answering as the full prompts sent to B, the release (paged: requests
     filling the whole pool then evict every cached page, the released
     chain's included, and the pool ends as it began); 4 greedy streams of
     128 new tokens and a sampled one (temperature 0.8, a prngKey) ejected
     from A by POST /v1/admin/eject once each has streamed 8 tokens, every
     stream ending in a migrate frame whose resume state B continues as
     resumeFrom, streamed: the spliced stream equals B's uninterrupted
     transcript, offsets contiguous; a queued and a decoding request
     cancelled through /v1/cancel and read through /v1/result; both
     metrics ports scraped, every family parsed, the resume and eject
     counters equal to what the phase did; it prints a `fleet` line with
     the card, TTFT of the prefix requests against the full prompts and
     the prefill chunks saved, the eject's wall ms, resumed against fresh
     TTFT, and the checkpoint phase's swap pauses with and without a
     prefix); the trainer main in-process, 4 steps at batch 8
     (the p/ds stash is over its gate, so dK/dV are recomputed) and 2 at
     batch 4 (the stash path); and the flagship configuration through
     train.trainer.train_loop, cut to batch 32 (grad_accum 4 instead of
     32) for 1 warm-up and 3 timed steps (the t-layout RoPE pair, flash at
     head_dim 512 with the p/ds stash, the fused CE kernels). The tenancy
     phase preempts batch requests for interactive ones on the graphed
     paged engine. The disagg phase runs the JAX package's chunked-prefill
     storm (40 requests, prompts cycling 8, 8, 8, 128, 8, 8, 8, 64 tokens,
     arrivals on the work clock) and the same requests as one burst on
     both engines at prefill_chunk_tokens 0 and 32, graphed and eager
     (graphed == eager bit for bit, 2 captures on a chunked engine, 1 on a
     plain one, the short class's TTFT in work tokens and ms, the quanta;
     in f32 the chunked engines' tokens equal the plain ones', in bf16
     they are counted), hands 8 streams (greedy and sampled) from a
     --disagg prefill serve main to a --disagg decode one (the prefill
     replica never decodes nor captures, counts 8 handoffs on both
     metrics routes; every splice equal to a mixed replica's stream in
     f32, counted in bf16) and sends SIGTERM to a serve main in its own
     process with a 2 s eject grace (the migrate frame within 3.5 s, exit
     0). The int8kv phase runs both engines with the int8 KV cache
     (kv_cache_int8) on the paged phase's prompts, graphed and pipelined,
     greedy and sampled, held bit for bit to eager engines: int8 K/V and
     f32 scales at the engines' shapes, the paged decode kernel never
     launched (the JAX engine's paged kernel is off under int8), no page
     leaked, prefill logits within 2 % of the bf16-KV range; in f32 the
     dense and paged int8 engines and the plain versions' engine give the
     same tokens, and an ejected request and a preempted batch request
     resume to their uninterrupted tokens; one FaultLab fault at each of
     the engine's five sites on the graphed paged engine fails exactly the
     requests of its containment class (the JAX engine's), the rest and
     later requests keep the unfaulted tokens; a serve main started with
     KTWE_FAULT_* counts its injections in /v1/metrics and on its metrics
     port; it prints the K/V bytes and ms a decode step, int8 against bf16
     KV at max_seq 256 and 4096, and the bf16 streams they agree on. The
     observability phase runs three paged serve mains (graphed, bf16, a
     bearer token): A with the flight recorder, the traffic trace and the
     optimizer telemetry on (--span-out, --trace-out,
     --slo-capture-threshold 0.001, --optimizer-url to a stub HTTP server in
     this script that counts pushes and checks their bearer token,
     --telemetry-interval 1, --tenants 2), B likewise, and C with none of
     those flags; A and C answer the serving cell's 9 greedy requests in
     turn (their tokens must be equal), A also one request with an incoming
     traceparent (its trace id kept), a stream ejected and resumed on B
     under one traceparent, and a budget 429. Gates: every final view's
     traceId has one replica.generate root in its main's span NDJSON, with
     admission, queue_wait, prefill and decode children; the prefill_chunk
     events equal the prefill chunks; the eject and resume marks share the
     trace; one trace record a terminal view plus one rejected record;
     /v1/admin/trace rotates, /v1/admin/spans and /v1/admin/slow-requests
     answer (C's 400); a telemetry push with the serve's bucket, tenants 2
     and slots 8; the 98 families served, the 19 new ones 0 on C; one
     decode graph capture a main. It prints ms a token p50 and commit
     seconds a token with the recorder on against off, the host ms of
     FlightRecorder.record a request, and span and trace bytes a request.
     The spec phase runs speculative decoding (spec_k 4) on both engines,
     graphed, on four traffics: the serving cell's 8 prompts drafted by an
     oracle of the spec-off transcripts, 8 prompts of a repeated 8-token
     cycle under the n-gram drafter, 4 greedy and 4 sampled requests, and
     an adversarial drafter that collapses the controller to bypass
     chunks. Gates: in f32 the spec engines' tokens equal the spec-off
     engines' (sampled streams too) with verify rounds and every oracle
     draft accepted (the n-gram traffic's rounds are counted: random
     weights need not continue a cycle); graphed == eager bit for bit; one verify-graph capture
     an engine, whose replay launches one gather and 2L+1 norms only; the
     launches of each engine exactly those of its chunks, steps and verify
     rounds (the paged decode kernel L times a step that is no verify
     round); no page leaked; a --spec-k 4 serve main's `spec` block and
     its 8 spec families (98 served), --spec-k with --int8-kv exit 2; the
     generate main with --speculate-draft-layers 4 --speculate-k 4 at its
     defaults, and the same speculative generation in f32 equal to the
     plain greedy one with the launches of its passes. It prints the
     verify round's device ms against a decode step's, draft host ms a
     round, tokens a round, acceptance and ms a token p50 against
     spec-off, per traffic and engine, and the bf16 streams equal to
     spec-off.
     The kvhost phase runs the paged engine with a host KV tier of 64
     blocks under a pool cut from 129 pages to 41, graphed: wave A on 3 of
     6 distinct 128-token prefixes, wave B on the other 3 (which evicts A's
     pages into the tier), then A's prefixes again under new suffixes,
     which prefetch them. Gates: every restored page equals the demoted
     page bit for bit (k and v, and an int8 engine's k, v and scales);
     graphed == eager with the tier on; every block the re-arrivals match
     a tier hit; the launches exactly those of its chunks and steps; no
     page leaked; in f32 the tier engine's tokens equal a tier-off engine's
     whose pool holds every wave, and a fault at kvhost.dma, kvhost.fetch
     and kvhost.corrupt each ends as a plain re-prefill with those tokens,
     counted; two --kv-host-blocks serve mains ship a prefix over
     /v1/kvhost to a prefetch hit with equal tokens, the kvhost block and
     the 8 kvhost families, and --kv-host-blocks without --kv-block-len
     exits 2. It prints TTFT p50 of the prefetched re-arrivals against the
     same re-arrivals re-prefilled with the tier off, one page's copy each
     way in device ms against the host link, the tier's dma seconds a
     block, the host ms a demotion adds to an admission and the pinned
     host bytes.
     The moe phases run Mixture-of-Experts (4 experts a layer, top-1): the
     MoE engines at the serve defaults, dense and paged (the dense
     one-hot expert route at every decode step, inside the captured
     graph), greedy and sampled, held bit for bit to eager engines, with a
     spec engine (spec_k 4, an oracle drafter) graphed against eager and
     its verify replay one gather and 2L+1 norms; their launches exactly a
     dense model's per chunk and step (MoE adds no table kernel); in f32
     the graphed dense and paged MoE engines' tokens equal the plain
     versions' eager engine's; it prints device ms a decode step against
     the dense model's engine in the same phase and the weight bytes a
     step reads. The census phase warms an engine in each mode at the
     serve defaults (dense and paged; plain, spec, chunked prefill, MoE)
     under the program-event sentinel (analysis/compilewatch.py): exactly
     the graphs of its mode, each captured once (chunk; quantum with
     chunked prefill; verify round with spec), no kernel build or load;
     then new prompts and lengths and a weight swap on every engine: zero
     post-warm captures and builds. The trainer main at its defaults with
     --n-experts 4 (1.88 B parameters; the ragged dispatch) trains 4
     steps: step ms, tokens/s, MFU, peak memory, aux, finite losses and
     grad norms, a dense step's launches; an f32 MoE gate (the trainer
     gate's dims, 4 experts, the ragged and the dense route) holds the
     loss and every gradient leaf, router and experts included, through
     the kernels to the plain versions at the gates' limits.
     The fsdp phase runs the trainer main at its defaults (4 steps at
     batch 8) as a gang of one rank through train/bootstrap.py
     (NUM_PROCESSES=1, KTWE_STRATEGY=FSDP, a localhost
     COORDINATOR_ADDRESS, and the main's group_of_one, since one process
     otherwise trains on the single-device path): an NCCL process group
     of one, the 5-axis DeviceMesh and the FSDP step (each layer's leaves
     all-gathered before use, their gradients reduce-scattered, the norm
     scales all-reduced). Gates: an NCCL group of one that main closes;
     per step exactly the train phase's launches; losses equal to the
     train phase's (same seed and batches) and grad norms within
     FSDP_GNORM_RTOL of them. It prints ms a step of both paths, peak
     memory, the bytes a rank holds of params and each Adam moment, and
     the card. The tenant_drain phase runs the port's
     CheckpointingTenantPool on the card: two f32 tenants at the trainer's
     default widths and depth (DRAIN_DIMS, batch 2) train 3 steps, drain
     through the pool's callbacks to a stand-in instance (an 8 GB
     checkpoint each) and resume; their next 2 losses equal an undrained
     tenant's within DRAIN_RTOL, and every step launches an f32 train
     step's kernels. It prints each drain's and resume's seconds and
     checkpoint bytes. The ring phase (tensor- and sequence-parallel
     training, parallel/ring_attention.py) holds the flash kernels' LSE
     entry point, `flash_attention_lse`, O, LSE and its backward with a
     nonzero LSE cotangent, against the plain versions at the trainer's
     attention width (batch 2, seq 2048, 16 heads of 128, bf16) and at a
     small f32 shape; then runs the ring's per-step block function
     (`ring_step`) for 4 virtual sp ranks in one process, the shift
     replaced by indexing into the held shards, at seq 8192 (shards of
     2048), batch 2, bf16, with 16 heads of 128 and 4 of 512, and holds
     its output and gradients (autograd through the blocks) against one
     `flash_attention_train` call on the whole causal sequence (RING_RTOL,
     RING_ATOL_OF_MAX). The gathered form (JAX's use_ring_attention=False,
     `gathered_attention`) runs on 4 virtual sp ranks of a ThreadGroup at
     the same shapes: each rank's 2048 queries at their global offset over
     the whole 8192 keys gathered from the ranks (one autograd node), the
     flash kernels at Sq 2048, Sk 8192 and a nonzero q_offset (16 heads of
     128: the recompute dK/dV, row 9, the stash over its gate; 4 of 512:
     the stash dK/dV, row 8), one backward over the ranks' losses; its
     output and gradients are held to the single call and to the ring at
     the same limits, and each rank's own dK and dV of the gathered K/V
     (the kernels called at its offset) to exact zeros on every row past
     its last query. It prints the launches of flash rows 6-9 (the
     schedule's, the gathered form's forward by rank and backward, and,
     apart, the single call's), ms of forward plus backward of each, and
     their peak GB; a multi-rank ring needs more than one card. The ep phase (expert parallelism,
     models/transformer.py `_moe_ffn` under parallel/sharding.ExpertLayout)
     runs the embedding and 2 MoE blocks at the trainer's widths (4
     experts, d_ff 8192, 16 heads of 128, seq 2048) on 4 virtual ep ranks
     of a ThreadGroup on the card, a batch of 8: each rank one expert a
     layer and 2 rows, its dispatched tokens carried to the experts' ranks
     and back by two all-to-alls a layer (one autograd node over the
     gang's ranks, whose backward is the inverse exchange); the ranks'
     forwards run in their threads and one backward over the sum of their
     losses. In f32 the output, aux, loss and every gradient leaf (router
     and experts included) are held to the single-device dense route on
     the same weights, rows and output cotangent (GATE_LOSS_RTOL,
     GATE_LEAF_RTOL); in bf16 the errors are printed. Gates: the table
     kernels' launches exactly each rank's embedding and blocks (rows 1-3,
     6, 7 and 8 at 2 rows a rank, the p/ds stash fitting its gate, 13), in
     bf16 every flash launch on its wgmma body; 4 all-to-alls a rank a
     layer (the pin of parallel/comm_gate.py), each E * N_local * D values.
     It prints an `ep` line with host ms of the forward and the backward
     against the single device's, peak GB, the launches and the
     all-to-alls' count and bytes. The pp phase (pipeline parallelism,
     parallel/pipeline.py and parallel/sharding.StageLayout) runs on
     virtual pp ranks of a ThreadGroup on the card: (a) the explicit GPipe
     schedule (`gpipe_lm_loss`) at the trainer main's widths, 8 layers on
     4 stages (2 a stage), a batch of 8 as 4 microbatches of 2, each
     stage's layers the model's own `_layer` (its kernels), the
     activations handed from stage to stage (the tensors themselves, so
     one backward from one thread runs the schedule's backward), the
     embedding on stage 0, the final norm, head and chunked CE on every
     stage; (b) the layer-stack form on 2 stages with the ep phase's MoE
     blocks (4 experts, one layer a stage, broadcast from its stage,
     every rank on the same 8 rows). In f32 the loss and every gradient
     leaf of both are held to one device's on the same weights and rows
     (GATE_LOSS_RTOL, GATE_LEAF_RTOL); bf16 is recorded. Gates: each
     rank's forward launches of the table kernels exactly its stage's
     (row 13 on stage 0; rows 1, 3 and 6 on every stage; in (a) at 2 rows
     a microbatch, in (b) at 8 rows), the backward's exactly the stages'
     sum (rows 2, 3, 7, and 8 at 2 rows, 9 at 8), in bf16 every flash
     launch on its wgmma body; each rank's p2p handoffs exactly its
     stage's pin (parallel/comm_gate.py `train/gpipe/pp2`: one a
     microbatch and neighbour each way), each at most one microbatch's
     activation; (b)'s broadcasts 10 a layer a rank (the pin
     `train/dp2_pp2_ep2/moe`). (c) The GPipe schedule on a virtual (pp=2,
     tp=2) gang (StageLayout with a tp Comm, JAX's schedule replicated over
     tp): the trainer's widths cut to 4 layers (2 a stage), the batch of 8
     as 4 microbatches of 2, each rank its tp blocks, the stage gathered
     whole over tp (every tp rank runs whole heads and the whole MLP: rows
     1, 3 and 6 on every rank as in (a)), the embedding, head and CE
     vocab-parallel (no row 13); the f32 loss and every gradient leaf
     (the ranks' blocks joined) held to one device's, bf16 recorded, the
     gang's collectives exactly the ranks' pins (`train/gpipe/pp2_tp2/
     threads`). It prints a `pp` line with bubble_fraction,
     host ms of the gang and of one device, peak GB, the launches and the
     handoffs; p2p and tp gathers between cards need more than one card
     and are not measured. The mesh phase (serving meshes, models/serving.py)
     runs the meshed programs at the serve defaults' full width on
     virtual gangs of threads on the one card (parallel/comm.ThreadGroup):
     the dense engine on (dp=2, tp=4), f32 transcripts of 8 prompts gated
     bit for bit to the unmeshed engine's (the max |delta logit| of one
     prefill printed), bf16 counted; the paged engine on (1, 4), f32,
     plain, int8 KV and spec_k 3 (an oracle drafter whose last draft a
     round is wrong), transcripts and page counters equal, verify rounds
     run; both MoE engines (4 experts) on (1, 4), f32, their transcripts
     equal to the unmeshed MoE engine's and every decode chunk the dense
     model's collectives (`serve/decode_chunk/paged/moe`); no gang above
     one rank launches a kernel (the JAX package's `pallas_ok`); the
     device-loss drill on the dense (2, 4) gang (every
     request evacuated as a resume frame that resumes to its
     uninterrupted transcript, the degraded engine serving one more equal
     request through rows 1, 3, 6 and 13, the serve's `mesh` block at one
     device, degraded); the paged engine on a (1, 1) mesh through an NCCL
     process group of one in bf16, its tokens, launches and one graph
     capture those of the unmeshed engine; the serve main's --mesh 2,4
     exiting 2 ("needs 8 devices"). The host KV tier on a mesh: the
     kvhost phase's traffic (6 prefixes, a pool of KVHOST_BLOCKS pages
     under a tier of KVHOST_TIER blocks) in f32 on a (1, 4) thread gang
     and on the (1, 1) mesh over an NCCL group of one: offloads,
     prefetches and hits above 0, every rank's restored page bit for bit
     the shard that rank held when the page was demoted, tokens those of a
     tier-off engine on the same mesh and pool, and on (1, 1) one graph
     capture and none after the restores; the demotion's and restore's
     collectives held to their pins and page bytes
     (parallel/comm_gate.py), host ms a page each way and their header
     bytes printed. The collective-budget gate at full width: every decode
     chunk of the dense (2, 4) gang (f32) and of the paged (1, 4) gang
     held to the pinned counts at 3 layers and 8 steps and to the size
     gate's activation-row caps, the counts and largest bytes printed. The
     collective bench (cmd/icibench.py) runs its single-rank case over an
     NCCL group of one, its line printed (`icibench`). It prints ms a
     decode step of each gang against the unmeshed eager engine, the
     driver's broadcast bytes and ms a header and headers a decode step,
     and peak GB; a gang across cards needs a machine with more than one.
     Every
     phase
     must launch exactly the kernels its prefill chunks, decode steps,
     train steps and microbatches need (one embedding gather a chunk, step
     and microbatch; the flagship's relayout pair 2L times each a
     microbatch; on the paged
     path the paged decode kernel L times a step, and never the dense
     decode attention). The dense phase's first prefill chunk and first
     tokens are checked against the plain versions; the paged engine is
     held to the dense engine: identical greedy transcripts in f32 on the
     same weights (a hard gate), and the count of identical ones in bf16,
     printed. Both engine phases run the decode chunk as one captured CUDA
     graph, replayed, under the overlapped dispatch/commit pipeline with
     the watchdog armed (30 s; it must not trip): one capture serves each
     engine, the launch counts come through the replays, and every request
     is held bit for bit, tokens and logprobs, greedy and again sampled
     (temperature 0.8), to an eager engine with the commit serialized
     (cuda_graph=False, overlap_commit=False) on the same weights and
     prompts; a `hotpath` line per engine prints the fetch-sync and commit
     seconds a token and the commit's overlapped share. Two f32 training
     gates at full width (the trainer's: 2 layers, batch 2, seq 512; the
     flagship's: 1 layer, batch 1, seq 512)
     hold the loss and every gradient leaf through the kernels, once with
     the p/ds stash and once with dK/dV recomputed, to the same step
     through the plain versions; the trainers' losses and grad norms must
     be finite. The backward kernels are held to limits scaled to each
     output's own values (BWD_RTOL, BWD_ATOL_OF_RMS);
     Every bf16 flash forward of every phase must run the tensor-core
     (wgmma) body, and so must every bf16 dQ and stash dK/dV launch (the
     train phases and the flagship at head_dim 512), every recompute
     dK/dV of the train phase (head_dim 128) and every fused CE forward
     and backward of the flagship; no f32 gate's flash or fused CE kernel
     may. The flash, RMSNorm and fused CE libraries' build seconds,
     registers, spills and shared memory are printed first, and each backward and
     fused CE case names the body (and its instance) that ran it;
  4. opens torch.profiler windows: on three engine steps of the paged
     engine (8 decoding slots, DECODE_CHUNK decode steps each, one graph
     replay a step) after the paged phase, with ms a decode step and the
     host's own ms a chunk, then three more steps unprofiled with each
     phase of a step timed on the host and each replay bracketed by CUDA
     events (the live chunks' device ms and the idle share from them),
     and the same unprofiled window on 8 sampled requests (t 0.8); and on
     one step of the trainer
     main at its defaults and one flagship step of a single microbatch
     after the timed phases; prints
     the ten device operations with the most self time, the device's idle
     share and the named kernels' device ms in each; then the trace cell:
     train/profiling.trace_steps over eight steps of the trainer's
     default configuration and device_duty_cycle of its Chrome trace,
     within 1 point of 100 - the idle share of the same window;
  5. runs the nvml phase, the node's device layer (discovery/nvml.py,
     discovery/native_client.py, the agent and exporter mains) on the
     card: a probe compiled with the host cc against the toolkit's nvml.h
     must print the binding's structure sizes, field offsets and sizes and
     constant values; NVML's device with torch's UUID must have
     nvidia-smi's name and power limit; an idle sample, then 4 s of the
     port's flash forward at the trainer's shape back to back, sampled
     every 0.25 s from a second thread, then an idle sample 1.5 s after:
     the busy duty cycle (median from 1 s on) at least 80 % and above
     idle, hbm_total nvidia-smi's memory.total within 1 MiB, the used
     delta of a 4 GiB allocation the allocator's reserved delta within
     0.25 GiB, power in (0, limit], temperature nvidia-smi's within 3 C;
     the agent main with --shim-source auto (on a free port) must choose
     nvml and show an assigned workload busy in /v1/telemetry under the
     load, and the exporter main's /metrics (parsed here) the eight chip
     families for the card: busy under the load, its duty, power, memory
     and temperature there the client's read at each of 5 scrapes (median
     difference within 10 points, a tenth of the limit, 0.25 GiB, 3 C),
     and, 1.5 s after it, within the idle tolerances above (at a load's
     start the card's power reading overshoots its limit before the cap
     holds it); the phase launches the flash forward once a load step and
     no other kernel, all on the wgmma body (its launches are the phase's
     own, counted on no main path); it prints every reading, which `used`
     nvidia-smi reports, and the host ms of one read of every counter and
     of one agent pass (median of 100);
  6. prints the {"kernels": [...], "launch_floor_ms": ...} line, then the
     result line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.

Any failed phase exits non-zero before the result line. Without a CUDA card
it exits 1 at once.

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import gc
import io
import json
import os
import pickle
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense) for the bound column:
# HBM, the bf16 tensor-core rate and the f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FLOPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

SERVE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=3, n_heads=4,
                  n_kv_heads=4, d_ff=16384, max_seq=256)
NUM_SLOTS, PREFILL_LEN, DECODE_CHUNK = 8, 128, 8
N_REQUESTS, PROMPT_LEN, LONG_PROMPT_LEN, NEW_TOKENS = 8, 128, 160, 48
# The engine phases arm the watchdog (it must never trip) and repeat their
# prompts sampled at this temperature against the eager engine.
WATCHDOG_S, SAMPLED_T = 30.0, 0.8
# Engine steps (one decode chunk each) in the serving profiler window, and
# again in the unprofiled window after it.
SERVING_WINDOW_STEPS = 3
# The paged phase: pages of 16 tokens (16 per slot, an auto pool of 129),
# 8 requests sharing a 128-token prefix with 32-token suffixes, one cold.
KV_BLOCK_LEN, SHARED_PREFIX, SUFFIX = 16, 128, 32

# The fleet phase: a registered prefix of 160 tokens (128 cached dense, 160
# paged) under 8 requests of 32-token suffixes and 48 new tokens; 4 greedy
# streams of 128 new tokens and one sampled one (temperature 0.8), ejected
# once each has streamed 8 tokens (long enough that the graphed engine,
# ~0.7 ms a token, is still decoding every one of them when the eject lands
# through the engine lock); on the paged main, 8 requests of 15
# prompt and 241 new tokens (16 pages each: the whole pool) after the
# release; 8 streams of 240 new tokens (on the paged main the whole pool)
# and a ninth queued behind them for the cancels.
FLEET_PREFIX, FLEET_SUFFIX, FLEET_NEW = 160, 32, 48
# The tenancy phase (the paged engine, pages of 16): 8 batch requests of
# 96-token prompts and 128 new tokens fill the 8 slots; once each has
# committed TENANCY_ARRIVE tokens, 4 interactive requests of 64 tokens and
# 32 new arrive. It runs at preempt_cap 2 and at 0, greedy and sampled
# (keys [TENANCY_KEY, i]). The pool-pressure engine holds 4 batch
# requests in a pool of 61 pages: their 4 leases of 14 pages leave 5 free
# where an interactive request needs 6, with 4 slots free.
TENANCY_BATCH, TENANCY_BATCH_PROMPT, TENANCY_BATCH_NEW = 8, 96, 128
TENANCY_INTERACTIVE, TENANCY_I_PROMPT, TENANCY_I_NEW = 4, 64, 32
TENANCY_ARRIVE, TENANCY_KEY, TENANCY_POOL_BATCH = 16, 41, 4
TENANCY_POOL_BLOCKS = 62
# The disagg phase. The chunked-prefill storm of the JAX package's
# scripts/bench_disagg.py (chunked_prefill_storm, copied): 40 requests
# whose prompt lengths cycle [8, 8, 8, 128, 8, 8, 8, 64] with 16 new tokens,
# arriving on the work clock (decode steps + prefill chunks x prefill_len)
# at Poisson marks at 0.8 of the default engine's capacity, seed 23; at
# prefill_chunk_tokens 0 and 32. Then 8 streams (4 greedy, 4 sampled) of
# 64-token prompts and 64 new tokens handed off from a prefill replica to a
# decode replica. Then a serve main with a 2 s eject grace in a 30 s drain,
# whose migrate frame must arrive within GRACE_SLACK_S of the grace; its
# stream is long (max_seq 8192, one decode step a chunk) so it outlives the
# grace.
STORM_REQUESTS, STORM_NEW, STORM_SEED, STORM_CHUNK_TOKENS = 40, 16, 23, 32
DISAGG_STREAMS, DISAGG_PROMPT, DISAGG_NEW, DISAGG_KEY = 8, 64, 64, 31
GRACE_S, GRACE_DRAIN_TIMEOUT, GRACE_SLACK_S = 2.0, 30.0, 1.5
GRACE_MAX_SEQ, GRACE_NEW = 8192, 8000
MIGRATE_REQUESTS, MIGRATE_PROMPT, MIGRATE_NEW, MIGRATE_AFTER = 4, 32, 128, 8
# The int8kv phase: the speed comparison's long cache (8 dense slots of 4096
# rows hold 0.81 GB of bf16 K/V against 0.84 GB of weights) and new tokens
# a request; FaultLab's one fault a site (the occurrence that fires).
INT8_LONG_SEQ, INT8_SPEED_NEW = 4096, 64
FAULT_TARGETS = {"engine.dispatch": 2, "engine.collect": 2,
                 "engine.commit": 3, "engine.paged_admit": 1,
                 "engine.prefill": 1}
SAMPLED_TEMPERATURE, SAMPLED_KEY = 0.8, [7, 11]
# The observability phase: the optimizer stub's bearer token, the tenants a
# push reports, the slow-request threshold (low enough that the ring keeps
# every request), the prompts' seed and the incoming trace contexts (a plain
# request's, and the ejected-and-resumed stream's).
OBS_TOKEN, OBS_TENANTS, OBS_SLO_S, OBS_SEED = "obs-token", 2, 0.001, 19
OBS_TRACEPARENT = "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"
OBS_TRACEPARENT_MIGRATE = ("00-4bf92f3577b34da6a3ce929d0e0e4736-"
                           "00f067aa0ba902b7-01")
FLUSH_PROMPT, CANCEL_NEW = 15, 240
# The spec phase: spec_k 4; the n-gram traffic's prompts repeat an 8-token
# cycle (seed SPEC_SEED, which also keys the sampled requests) and take 64
# new tokens.
SPEC_K, SPEC_SEED, SPEC_CYCLE, SPEC_NGRAM_NEW = 4, 37, 8, 64
# The kvhost phase: 6 distinct 128-token prefixes (8 pages) under 32-token
# suffixes, 32 new tokens; the pool cut from the auto 129 pages to 41, so
# that 3 requests' 12 pages fill it and wave B evicts wave A's prefixes
# into a host tier of 64 blocks. The host link's rate for the copies'
# bound: PCIe Gen5 x16, 64 GB/s a direction (the H100 SXM's link to its
# host).
KVHOST_PREFIXES, KVHOST_PREFIX, KVHOST_SUFFIX, KVHOST_NEW = 6, 128, 32, 32
KVHOST_BLOCKS, KVHOST_TIER, KVHOST_SEED = 41, 64, 43
HOST_LINK_BYTES_PER_S = 64e9

# Training: the trainer main's defaults (cmd/trainer.py of the JAX package),
# and the stash-path batch (the p/ds stash is 1.07 GB at batch 4, under the
# 1.2 GB gate; 2.15 GB at batch 8, over it).
TRAIN_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
                  d_ff=8192, seq_len=2048)
TRAIN_BATCH, STASH_BATCH, TRAIN_STEPS, STASH_STEPS = 8, 4, 4, 2
# The checkpoint phase: the trainer main at the serve dims (4 heads of 512:
# the t-layout path), seq 256 (the serve max_seq), batch 8 (the p/ds stash
# is 8.4 MB a layer, under its gate), on a token shard of 48 windows; the
# serve mains answer greedy requests of 16 new tokens.
CKPT_BATCH, CKPT_WINDOWS, CKPT_NEW_TOKENS = 8, 48, 16
CKPT_HEAD_DIM = SERVE_DIMS["d_model"] // SERVE_DIMS["n_heads"]
# The f32 gate: full width, 2 layers, batch 2, seq 512.
GATE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=2, n_heads=16,
                 n_kv_heads=16, d_ff=8192, max_seq=512)
GATE_BATCH, GATE_LOSS_RTOL, GATE_LEAF_RTOL = 2, 1e-5, 1e-3
# The flagship training configuration (train/flagship.py: 3 layers, 4 heads
# of 512, d_ff 16384, seq 2048, bf16, single-chunk fused CE) at its
# microbatch of 8, cut from 32 microbatches a step to 4 (batch 32) to keep
# the run inside its time limit; 1 warm-up step and 3 timed ones.
FLAGSHIP_BATCH, FLAGSHIP_ACCUM, FLAGSHIP_STEPS = 32, 4, 4
FLAGSHIP_MICRO = FLAGSHIP_BATCH // FLAGSHIP_ACCUM
# Its f32 gate: the flagship widths, 1 layer, batch 1, seq 512.
FLAGSHIP_GATE_DIMS = dict(vocab_size=32768, d_model=2048, n_layers=1,
                          n_heads=4, n_kv_heads=4, d_ff=16384, max_seq=512,
                          ce_chunk=32768, ce_cache_logits=True)
FLAGSHIP_GATE_BATCH = 1
# The moe phases: MOE_EXPERTS experts a layer, top-1 (the trainer main's
# --n-experts 4: 1.88 B parameters, ~30 GB of f32 params, grads and AdamW
# moments at the trainer defaults, where 8 experts would need ~56 GB before
# activations); its trainer run of MOE_TRAIN_STEPS steps (one warm-up);
# the f32 gate at the trainer gate's dims with 4 experts, both routes.
MOE_EXPERTS, MOE_TRAIN_STEPS = 4, 4
MOE_GATE_DIMS = dict(GATE_DIMS, n_experts=MOE_EXPERTS)
# The trace cell: trace_steps over TRACE_STEPS default train steps,
# device_duty_cycle within TRACE_POINTS of 100 - the idle share of the same
# window. The two differ by the window's edges, a few ms whatever the step
# count (6.6 ms and ~8 ms of a 784 ms window of 3 steps, 0.81 and 1.02
# points, on an H100 80GB HBM3 at 700 W), so the window holds 8 steps.
TRACE_STEPS, TRACE_POINTS = 8, 1.0
# Fused CE forward vs plain: lse and gold relative (bf16: the tensor cores
# sum the logits in another order; f32: the f32 pipes in contraction order
# against cuBLAS); stash and dlg within one bf16 ulp (an f32 value within
# the sums' difference of a bf16 midpoint rounds to its neighbour), with
# the backward limits' floor of BWD_ATOL_OF_RMS[bf16] times the output's
# root mean square for entries near zero, where the sums' difference
# (~1e-5 at D 2048) is more than the value's ulp.
CE_STAT_RTOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}

# The ring phase: `flash_attention_lse` at the trainer's attention width
# (batch 2, seq 2048, 16 heads of 128, bf16) and an f32 gate (1, 256, 2,
# 128) against the plain versions, its backward with a nonzero LSE
# cotangent; then the ring schedule of RING_SP virtual sp ranks at seq
# RING_SEQ (shards of 2048), batch 2, bf16, at 16 heads of 128 and 4 of 512
# (dQ above head_dim 128 is another body), against one flash_attention_train
# call on the whole causal sequence.
RING_SP, RING_SEQ, RING_BATCH = 4, 8192, 2
RING_HEADS = ((16, 128), (4, 512))
LSE_SHAPES = (((2, 2048, 16, 128), torch.bfloat16),
              ((1, 256, 2, 128), torch.float32))
# The LSE, f32 either way, against the plain version: a row's sum of up to
# 2048 exponentials taken in another order (2048 * 2^-24 relative of the
# sum, so 1.2e-4 of its log) over scores of f32 sums of 128 products.
LSE_ATOL = 2e-4
# The ring schedule against the whole-sequence call, bf16: each of up to 4
# blocks' output is rounded to bf16 before the f32 merge, and autograd sums
# the blocks' dQ, dK and dV in bf16, where the single call rounds once: a
# few bf16 ulps (2^-8 of the value each), and where the blocks' terms
# cancel, a few ulps of the largest term, RING_ATOL_OF_MAX of the output's
# largest magnitude.
RING_RTOL, RING_ATOL_OF_MAX = 2.0 ** -6, 2.0 ** -6

# The mesh phase: 8 prompts of MESH_PROMPT tokens (one prefill chunk) and
# MESH_NEW new tokens on virtual gangs of threads (dense (2, 4), paged
# (1, 4)), spec_k 3 through an oracle drafter, the device-loss drill's
# three requests of MESH_DRILL_NEW tokens armed once the first has 3.
MESH_PROMPT, MESH_NEW, MESH_SPEC_K, MESH_SEED = 48, 16, 3, 47
MESH_DRILL_NEW = 12
# The collective bench's payload a rank (cmd/icibench.py's default).
ICIBENCH_MB = 256
# The ep phase: the embedding and EP_LAYERS MoE blocks at the trainer's
# widths (TRAIN_DIMS with MOE_EXPERTS experts: d_model 2048, 16 heads of
# 128, d_ff 8192, seq 2048) on EP_RANKS virtual ep ranks of a ThreadGroup
# on the card, a batch of EP_BATCH rows: each rank one expert of each
# layer and EP_BATCH / EP_RANKS rows, the dense expert route with the
# token all-to-alls between the ranks.
EP_RANKS, EP_LAYERS, EP_BATCH, EP_SEED = 4, 2, 8, 61
# The pp phase: (a) the GPipe schedule at the trainer main's widths
# (TRAIN_DIMS: 8 layers) on PP_STAGES virtual stages of a ThreadGroup, its
# batch of TRAIN_BATCH rows as PP_MICRO microbatches (2 rows each, the p/ds
# stash at its gate); (b) the layer-stack form on PP_LS_STAGES stages with
# the ep phase's MoE blocks (MOE_EXPERTS experts, EP_LAYERS layers: one a
# stage) on EP_BATCH rows a rank (the recompute dK/dV).
PP_STAGES, PP_MICRO, PP_LS_STAGES, PP_SEED = 4, 4, 2, 67
# (c) the GPipe schedule on a (PP_TP_STAGES, PP_TP) gang of threads at the
# trainer's widths cut to PP_TP_LAYERS layers: every tp rank holds its
# stage whole, so the gang holds each stage's weights and activations
# PP_TP times over.
PP_TP_STAGES, PP_TP, PP_TP_LAYERS = 2, 2, 4

# Kernel vs plain version in bf16: both round once from f32, so they differ
# by at most a couple of bf16 ulps (2^-8 relative) where their f32 sums are
# taken in another order.
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
# The fsdp phase's grad norm against the single-device step's: the same
# gradients (a gang of one gathers and reduce-scatters by copies), their
# squares summed in another order (one sum over the sharded leaves, one
# over the replicated ones); measured 8.4e-8.
FSDP_GNORM_RTOL = 1e-6
# First prefill chunk's f32 logits, kernels vs plain versions: bf16
# activations through 3 layers; a one-ulp flip upstream moves a logit by
# about 1e-2 at these magnitudes.
LOGITS_ATOL = 0.1
# Backward kernels vs plain versions: each output (and the p/ds stash) is
# held to a limit scaled to its own values. rtol: in bf16 one rounding (an
# ulp is at most 2^-7 of the value) of f32 results that differ only in
# summation order; in f32 those sums themselves (a few thousand terms: a
# few 1e-6 of the output's size). atol, for entries near zero where
# cancellation decides the last bits, is this fraction of the output's
# root mean square.
BWD_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float32: 1e-5}
BWD_ATOL_OF_RMS = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


# Each flash and fused CE kernel's count of launches on its bf16
# tensor-core body.
WGMMA_COUNTERS = {"flash_attention": "flash_attention_wgmma",
                  "flash_attention_bwd_dq": "flash_attention_bwd_dq_wgmma",
                  "flash_attention_bwd_dkv": "flash_attention_bwd_dkv_wgmma",
                  "flash_attention_bwd_dkv_stash":
                      "flash_attention_bwd_dkv_stash_wgmma",
                  "fused_ce_fwd": "fused_ce_fwd_wgmma",
                  "fused_ce_bwd": "fused_ce_bwd_wgmma"}
# The backward's tensor-core bodies in a build log, by kernel name.
BWD_WGMMA_INSTANCES = {
    "flash_bwd_dq_wgmma_kernel":
        "bf16, d<=128, 128 resident query rows, 64-key tiles, 2 stages",
    "flash_bwd_dkv_wgmma_kernel":
        "bf16, d<=128, 128 resident keys, 64-query tiles, 2 stages",
    "flash_bwd_dq_wide_wgmma_kernel":
        "bf16, 128<d<=512, 64 resident query rows, 32-key tiles, one stage "
        "each of K and V",
    "flash_bwd_dkv_stash_wgmma_kernelILb1E":
        "bf16, d<=512, 128 keys x 128-column slice, 64-query tiles, 3 "
        "stages, P and dS by TMA",
    "flash_bwd_dkv_stash_wgmma_kernelILb0E":
        "bf16, d<=512, 128 keys x 128-column slice, 64-query tiles, 3 "
        "stages, P and dS copied by the producer (Sk % 8 != 0)"}
# The fused CE library's kernels in a build log, by the name's distinct part.
CE_KERNELS = {
    "ce_wgmma_kernelILb1E": "ce_wgmma_kernel<forward: bf16, 128 x 256 "
                            "tiles, 64 deep, 4 stages, persistent>",
    "ce_wgmma_kernelILb0E": "ce_wgmma_kernel<backward dH: bf16, 128 x 256 "
                            "tiles, 64 deep, 4 stages, persistent>",
    "ce_dlg_kernel": "ce_dlg_kernel<backward dlg: bf16>",
    "ce_combine_kernel": "ce_combine_kernel<forward statistics>",
    "simt13ce_fwd_kernel": "ce_fwd_kernel<float>",
    "simt13ce_bwd_kernel": "ce_bwd_kernel<float>"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _events_ms(run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def device_ms(fn, iters: int = 50, replays: int = 5) -> float:
    """Device milliseconds per call: `iters` calls captured in one CUDA
    graph and replayed `replays` times between CUDA events, so the host's
    cost of issuing each call (Python, ctypes, launch) is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the graph
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()
    ms = _events_ms(run) / (iters * replays)
    del graph
    return ms


def wrapper_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Milliseconds per call over `iters` eager back-to-back calls: the
    rate at which the host issues them wherever that is slower than the
    device (small kernels), else the device time."""
    for _ in range(warmup):
        fn()

    def run():
        for _ in range(iters):
            fn()
    return _events_ms(run) / iters


def bound(bytes_moved: float, flops: float, dtype=torch.bfloat16):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FLOPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def expected_launches(n_layers: int, lifetime: dict, paged: bool = False,
                      verify_rounds: int = 0) -> dict:
    """Kernel launches an engine run must have made: every prefill chunk
    runs one embedding gather, 2L+1 norms, 2L RoPE rotations (q and k) and
    L flash calls, all on the tensor-core body (serving is bf16); every
    decode step one gather, 2L+1 norms and, on the paged engine, L paged
    decode calls of two kernels each, the split-KV kernel and its combine
    (dense decode RoPE and attention are plain torch). A speculative verify
    round counts one decode step: one gather over its (B, k+1) block and
    2L+1 norms, and no paged decode (its RoPE and attention are plain
    torch on both engines)."""
    chunks, steps = lifetime["prefill_chunks"], lifetime["decode_steps"]
    want = {"embed_gather": chunks + steps,
            "rms_norm": (2 * n_layers + 1) * (chunks + steps),
            "rope": 2 * n_layers * chunks,
            "flash_attention": n_layers * chunks,
            "flash_attention_wgmma": n_layers * chunks}
    if paged:
        want["paged_decode"] = n_layers * (steps - verify_rounds)
        want["paged_decode_combine"] = n_layers * (steps - verify_rounds)
    return want


def hotpath_report(eng) -> dict:
    """An engine run's hot path: host seconds a token waiting on the
    chunk fetch and committing, the commit's share that ran behind a chunk
    in flight, the decode graph's captures and replays, watchdog trips."""
    m = eng.metrics()
    hp, tokens = m["hotpath"], max(1, m["lifetime"]["tokens"])
    commit = hp["commit_s_total"]
    return dict(fetch_sync_s_per_token=hp["fetch_sync_s_total"] / tokens,
                commit_s_per_token=commit / tokens,
                commit_overlapped_share=(hp["commit_overlapped_s_total"]
                                         / commit if commit else 0.0),
                commit_rounds=hp["commit_rounds_total"],
                graphs_captured=hp["graphs_captured"],
                graph_replays=hp["graph_replays"],
                watchdog_trips=m["resilience"]["watchdog_trips"])


def decode_p50_ms(reqs) -> float:
    """The p50 of the requests' per-token decode latencies (TTFT left
    out), as the engine's token_lat_p50_ms takes it over all it keeps."""
    from k8s_gpu_workload_enhancer_tpu_torch.utils.stats import percentile
    return percentile(sorted(lat for r in reqs
                             for lat in r.token_lat_s[1:]), 50) * 1e3


def check_graphed(eng, what: str) -> dict:
    """One capture served every request of the graphed engine, its
    watchdog (armed) never tripped; returns its hot-path report."""
    hp = hotpath_report(eng)
    if hp["graphs_captured"] != 1 or hp["graph_replays"] < 1:
        fail(f"{what}: {hp['graphs_captured']} decode graphs captured, "
             f"{hp['graph_replays']} replays; want 1 capture replayed")
    if hp["watchdog_trips"]:
        fail(f"{what}: the watchdog tripped {hp['watchdog_trips']} times")
    return hp


def hold_to_eager(got: list, want: list, what: str) -> None:
    """The graphed, pipelined engine's requests against the eager,
    serialized engine's: tokens and logprobs bit for bit."""
    for i, (g, w) in enumerate(zip(got, want)):
        if g.tokens != w.tokens or g.logprobs != w.logprobs:
            fail(f"{what}: request {i} of the graphed engine differs from "
                 f"the eager engine: {g.tokens} / {w.tokens}")


def prefix_chunks(n_tokens: int, paged: bool) -> int:
    """Prefill chunks a registration (or a swap's re-prefill) of an
    n-token prefix runs, none of it matched in the tree: dense its
    prefill_len grid, paged its full blocks (the last chunk padded). They
    are not in the engine's prefill_chunks count."""
    if not paged:
        return n_tokens // PREFILL_LEN
    span = n_tokens // KV_BLOCK_LEN * KV_BLOCK_LEN
    return -(-span // PREFILL_LEN)


def cast_params(params, dtype):
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def errors(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float):
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail("kernel output has non-finite values")
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all())
    rel = float((diff / w.abs().clamp_min(1e-6)).max())
    return float(diff.max()), rel, ok


def bwd_errors(got: torch.Tensor, want: torch.Tensor):
    """`errors` at the backward limits for want's dtype (BWD_RTOL, and
    BWD_ATOL_OF_RMS times want's root mean square)."""
    rms_w = float(torch.linalg.vector_norm(want, dtype=torch.float32)) \
        / max(1, want.numel()) ** 0.5
    return errors(got, want, BWD_ATOL_OF_RMS[want.dtype] * rms_w,
                  BWD_RTOL[want.dtype])


def ptxas_entries(log: str) -> list:
    """Each kernel of a library's build log (`nvcc -Xptxas -v`): its name,
    registers at launch, spill bytes and static shared memory."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            shape = re.search(r"ShapeILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
            bwd = re.search(r"(flash_bwd_\w+?_kernel)I(f|13__nv_bfloat16)Li(\d+)E",
                            name)
            wgmma = next((k for k in BWD_WGMMA_INSTANCES if k in name), None)
            ce = next((k for k in CE_KERNELS if k in name), None)
            rms = re.search(r"(rms_norm_\w+?_kernel)I(f|13__nv_bfloat16)"
                            r"(f|13__nv_bfloat16|S1_)Li(\d+)ELi(\d+)E", name)
            fin = re.search(r"rms_dw_finalize_kernelI(f|13__nv_bfloat16)"
                            r"Li(\d+)E", name)
            pd = re.search(r"paged_decode_(mma|simt|combine)_kernelI"
                           r"(?:Li(\d+)E|f(?:Li(\d+)ELi(\d+)E)?"
                           r"|13__nv_bfloat16)", name)
            if pd:
                kind, cw, rows, cw2 = pd.groups()
                name = ("paged_decode_mma_kernel<bf16, %s-byte copies>" % cw
                        if kind == "mma" else
                        "paged_decode_simt_kernel<f32, %s rows, %s-byte "
                        "copies>" % (rows, cw2) if kind == "simt" else
                        "paged_decode_combine_kernel<%s>" % (
                            "f32" if "I13" not in name else "bf16"))
            elif rms:
                x_t = "f32" if rms.group(2) == "f" else "bf16"
                w_t = {"f": "f32", "S1_": x_t}.get(rms.group(3), "bf16")
                name = "%s<x %s, w %s, %s a vector, V %s>" % (
                    rms.group(1), x_t, w_t, rms.group(4), rms.group(5))
            elif fin:
                name = "rms_dw_finalize_kernel<dw %s, %s a load>" % (
                    "f32" if fin.group(1) == "f" else "bf16", fin.group(2))
            elif ce:
                name = CE_KERNELS[ce]
            elif shape:
                name = ("flash_fwd_wgmma_kernel<d<=%s, %s query rows, %s keys,"
                        " %s stage(s)>" % shape.groups())
            elif "flash_fwd_kernelIf" in name:
                name = "flash_fwd_kernel<float>"
            elif bwd:
                name = "%s<%s, d<=%s>" % (
                    bwd.group(1), "float" if bwd.group(2) == "f" else "bf16",
                    bwd.group(3))
            elif wgmma:
                name = "%s<%s>" % (wgmma.split("I")[0],
                                   BWD_WGMMA_INSTANCES[wgmma])
            cur = dict(kernel=name)
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur.update(spill_stores=int(m.group(1)),
                       spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return out


def flash_body(flash, dtype, d: int) -> dict:
    """Which forward body `ktwe_flash_attention_fwd` runs for dtype and
    head_dim, and the dynamic shared memory a block of it takes."""
    lib = flash.kernels.library("flash_attention")
    smem = lib.ktwe_flash_attention_smem(d, flash.kernels.DTYPE_CODES[dtype])
    if dtype != torch.bfloat16:
        return dict(body="f32 pipes", dynamic_smem_bytes=smem)
    return dict(body="wgmma", instance="d<=128" if d <= 128 else "d<=512",
                dynamic_smem_bytes=smem)


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def launch_floor_ms(dev) -> float:
    """Device ms of the least a launch costs: a one-element zero_() on the
    card, timed as the kernels are (calls captured in one CUDA graph)."""
    z = torch.empty(1, device=dev)
    return device_ms(lambda: z.zero_())


def device_kernels(fn, tries: int = 3) -> dict:
    """One call of fn under torch.profiler: how many CUDA kernels it
    launched, their device ms summed and their names. The window is fenced
    by a spin kernel (`torch.cuda._sleep`) before and after fn; one in
    which the profiler did not record both fences is incomplete and is
    taken again, up to `tries` windows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        spans = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
                 for e in prof.events() if e.device_type == DeviceType.CUDA]
        fences = sum("spin_kernel" in name for name, _ in spans)
        spans = [(n, ms) for n, ms in spans if "spin_kernel" not in n]
        if fences == 2:
            return dict(launches=len(spans),
                        device_ms=sum(ms for _, ms in spans),
                        kernels=[name[:80] for name, _ in spans])
    fail(f"no profiler window recorded both fences in {tries} tries")


def main_path_rotation(dev, attn_mod, rope, randn) -> dict:
    """RoPE as a prefill chunk runs it: `attention.apply_rope` of one
    chunk's q on the (max_seq, D/2, 2) table at offset 128, forward (no
    autograd, as serving runs it) and its VJP through autograd. Each call's
    kernel launches and their device ms come from the profiler (whatever
    the call launches around the kernel counts); the forward is also timed
    as the kernels are (CUDA graph), both at their eager rate. Both are
    held bit for bit to the plain rotation; a call of more than one launch
    fails."""
    h = SERVE_DIMS["n_heads"]
    hd = SERVE_DIMS["d_model"] // h
    off = PREFILL_LEN
    freqs = attn_mod.rope_frequencies(hd, SERVE_DIMS["max_seq"], 10000.0, dev)
    x, g = randn(1, PREFILL_LEN, h, hd), randn(1, PREFILL_LEN, h, hd)
    fr = freqs[off:off + PREFILL_LEN]
    c, sn = fr[..., 0], fr[..., 1]
    xg = x.detach().requires_grad_()
    y = attn_mod.apply_rope(xg, freqs, off)

    def fwd():
        return attn_mod.apply_rope(x, freqs, off)

    def vjp():
        return torch.autograd.grad(y, (xg,), g, retain_graph=True)[0]
    ok = bool(torch.equal(fwd(), rope.rope_rotate_plain(x, c, sn))
              and torch.equal(vjp(), rope.rope_rotate_plain(g, c, -sn)))
    res = dict(call="attention.apply_rope(x, freqs, 128)",
               shape=[1, PREFILL_LEN, h, hd], dtype="bfloat16", ok=ok,
               forward=dict(device_kernels(fwd), ms=device_ms(fwd),
                            wrapper_ms=wrapper_ms(fwd)),
               vjp=dict(device_kernels(vjp), wrapper_ms=wrapper_ms(vjp)))
    if not ok:
        fail(f"apply_rope or its VJP disagrees with the plain rotation: {res}")
    if res["forward"]["launches"] != 1 or res["vjp"]["launches"] != 1:
        fail(f"a main-path rotation took more than one launch: {res}")
    return res


def check_kernels(dev, rms, rope, flash, paged, attn_mod) -> dict:
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    d, h, hd = SERVE_DIMS["d_model"], SERVE_DIMS["n_heads"], 2048 // 4
    out = {}

    # RMSNorm: a prefill chunk's rows, a decode step's, a ragged small
    # shape, and a chunked-prefill slice's rows (the disagg phase).
    cases = []
    w = (1.0 + 0.1 * randn(d, dtype=torch.float32)).to(torch.bfloat16)
    for case, rows, width in (("prefill", PREFILL_LEN, d),
                              ("decode", NUM_SLOTS, d), ("ragged", 5, 203),
                              ("prefill_chunk32", STORM_CHUNK_TOKENS, d)):
        x = randn(rows, width)
        ww = w if width == d else (1.0 + 0.1 * randn(width)).to(torch.bfloat16)
        got = rms.rms_norm(x, ww)
        want = rms.rms_norm_plain(x, ww)
        ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
        bts = 2 * x.numel() * 2 + ww.numel() * 2
        b_ms, b_by = bound(bts, 4.0 * x.numel())
        lib_ms = device_ms(lambda: torch.nn.functional.rms_norm(
            x, (width,), ww, 1e-6))
        cases.append(dict(case=case, shape=[rows, width], dtype="bfloat16",
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(lambda: rms.rms_norm(x, ww)),
                          wrapper_ms=wrapper_ms(lambda: rms.rms_norm(x, ww)),
                          plain_ms=device_ms(
                              lambda: rms.rms_norm_plain(x, ww)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    out["rms_norm"] = cases

    # RoPE: one prefill chunk's q (offset 0 and 128), a ragged shape, and a
    # chunked-prefill slice's q at offsets 32 and 96 (the disagg phase), on
    # the cos/sin views of the (max_seq, D/2, 2) table the main path hands
    # the kernel (read in place); bit for bit.
    cases = []
    freqs = attn_mod.rope_frequencies(hd, SERVE_DIMS["max_seq"], 10000.0, dev)
    c32 = STORM_CHUNK_TOKENS
    for shape, offset in (((1, PREFILL_LEN, h, hd), 0),
                          ((1, PREFILL_LEN, h, hd), PREFILL_LEN),
                          ((2, 7, 3, 24), 5),
                          ((1, c32, h, hd), c32), ((1, c32, h, hd), 3 * c32)):
        x = randn(*shape)
        s, dd = shape[1], shape[3]
        fr = (freqs if dd == hd else attn_mod.rope_frequencies(
            dd, 64, 10000.0, dev))[offset:offset + s]
        c, sn = fr[..., 0], fr[..., 1]
        got = rope.rope_rotate(x, c, sn)
        want = rope.rope_rotate_plain(x, c, sn)
        ea, er, _ = errors(got, want, BF16_ATOL, BF16_RTOL)
        ok = bool(torch.equal(got, want))
        bts = 2 * x.numel() * 2 + 2 * c.numel() * 4
        b_ms, b_by = bound(bts, 3.0 * x.numel())
        cases.append(dict(shape=list(shape), offset=offset, dtype="bfloat16",
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(lambda: rope.rope_rotate(x, c, sn)),
                          wrapper_ms=wrapper_ms(
                              lambda: rope.rope_rotate(x, c, sn)),
                          plain_ms=device_ms(
                              lambda: rope.rope_rotate_plain(x, c, sn)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=None))
    cases[0]["main_path_rotation"] = main_path_rotation(dev, attn_mod, rope,
                                                        randn)
    out["rope"] = cases

    # Flash: a prefill chunk against the static 256-row cache, at q_offset 0
    # and 128, a ragged GQA shape, and a chunked-prefill slice of 32 rows
    # (shorter than a 64-row tile) at q_offset 32 and 96 (the causal
    # boundary inside a key tile; the disagg phase). Then a speculative
    # round's k+1 = 5 query rows at q_offset 131 and max_seq - 6, bf16 and
    # f32: at the serve dims (head_dim 512, the 64-row tiles) and at the
    # generate main's defaults (8 heads of 128, the 128-row tiles; its
    # cache of 128 + 64 + k + 1 = 197 rows), as generate_speculative's
    # passes give them to the kernel.
    cases = []
    s_max = SERVE_DIMS["max_seq"]
    f32, gen_seq = torch.float32, 128 + 64 + SPEC_K + 1
    tol = {torch.bfloat16: (BF16_ATOL, BF16_RTOL), f32: (1e-5, 1e-5)}
    for (b, sq, sk, hh, kh, dd), q_off, dt in (
            ((1, PREFILL_LEN, s_max, h, h, hd), 0, torch.bfloat16),
            ((1, PREFILL_LEN, s_max, h, h, hd), PREFILL_LEN, torch.bfloat16),
            ((2, 19, 45, 4, 2, 72), 20, torch.bfloat16),
            ((1, c32, s_max, h, h, hd), c32, torch.bfloat16),
            ((1, c32, s_max, h, h, hd), 3 * c32, torch.bfloat16),
            ((1, SPEC_K + 1, s_max, h, h, hd), 131, torch.bfloat16),
            ((1, SPEC_K + 1, s_max, h, h, hd), s_max - 6, torch.bfloat16),
            ((1, SPEC_K + 1, s_max, h, h, hd), 131, f32),
            ((1, SPEC_K + 1, s_max, h, h, hd), s_max - 6, f32),
            ((1, SPEC_K + 1, gen_seq, 8, 8, 128), 131, torch.bfloat16),
            ((1, SPEC_K + 1, gen_seq, 8, 8, 128), gen_seq - 6,
             torch.bfloat16),
            ((1, SPEC_K + 1, gen_seq, 8, 8, 128), 131, f32),
            ((1, SPEC_K + 1, gen_seq, 8, 8, 128), gen_seq - 6, f32)):
        q, k, v = (randn(b, n, hh_, dd, dtype=dt)
                   for n, hh_ in ((sq, hh), (sk, kh), (sk, kh)))
        got = flash.flash_attention(q, k, v, True, q_off, 0)
        want = flash.flash_attention_plain(q, k, v, True, q_off, 0)
        ea, er, ok = errors(got, want, *tol[dt])
        # Work this run's data needs: query row i sees keys
        # [0, min(sk, q_off + i + 1)).
        vis = [min(sk, q_off + i + 1) for i in range(sq)]
        flops = 4.0 * dd * sum(vis) * b * hh
        kv_rows = max(vis)
        bts = q.element_size() * (2 * q.numel() + 2 * b * kv_rows * kh * dd)
        b_ms, b_by = bound(bts, flops, dt)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        kt = kt.repeat_interleave(hh // kh, dim=1)
        vt = vt.repeat_interleave(hh // kh, dim=1)
        mask = (q_off + torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :])
        lib_ms = device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask))

        def kernel():
            return flash.flash_attention(q, k, v, True, q_off, 0)
        cases.append(dict(shape=dict(b=b, sq=sq, sk=sk, h=hh, kh=kh, d=dd),
                          q_offset=q_off, dtype=str(dt).split(".")[-1],
                          **flash_body(flash, q.dtype, dd),
                          max_abs_err=ea, max_rel_err=er, ok=ok,
                          ms=device_ms(kernel), wrapper_ms=wrapper_ms(kernel),
                          plain_ms=device_ms(
                              lambda: flash.flash_attention_plain(
                                  q, k, v, True, q_off, 0)),
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    out["flash_attention"] = cases
    out["paged_decode"], out["paged_decode_combine"] = check_paged_decode(
        dev, gen, paged)
    for name, cs in out.items():
        for c in cs:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def check_paged_decode(dev, gen, paged) -> list:
    """The paged decode kernels (the split-KV kernel and its combine, one
    call) against their plain version in bf16 and f32: the paged engine's
    shape (8 slots, 4 heads of 512, pages of 16, 16 per slot, the auto pool
    of 129, positions 130-207, pages handed out in a shuffled order), a GQA
    shape (2 kv heads), the engine shape with slot 7 parked (all-trash row
    at position 255), a long-context shape (256 pages per slot, pool of
    2049, positions near 4000), 32 query heads of 128 on one kv head, and
    head_dim 1024 (2 heads)."""
    bl = KV_BLOCK_LEN
    shapes = [("engine", 4, 4, 512, 16, 129, (130, 207), False),
              ("gqa", 4, 2, 512, 16, 129, (130, 207), False),
              ("parked", 4, 4, 512, 16, 129, (130, 207), True),
              ("long", 4, 4, 512, 256, 2049, (3990, 4010), False),
              ("g32", 32, 1, 128, 16, 129, (130, 207), False),
              ("d1024", 2, 2, 1024, 16, 129, (130, 207), False)]
    cpu_gen = torch.Generator().manual_seed(3)
    cases, combine_cases = [], []
    for dtype in (torch.bfloat16, torch.float32):
        for name, h, kh, hd, mb, nb, (lo, hi), parked in shapes:
            b = NUM_SLOTS
            table = (torch.randperm(nb - 1, generator=cpu_gen)[:b * mb]
                     + 1).reshape(b, mb).to(torch.int32)
            pos = torch.linspace(lo, hi, b).round().to(torch.int32)
            if parked:
                table[-1] = 0
                pos[-1] = mb * bl - 1
            table, pos = table.to(dev), pos.to(dev)
            q = torch.randn((b, h, hd), generator=gen, device=dev).to(dtype)
            kp = torch.randn((nb, bl, kh, hd), generator=gen,
                             device=dev).to(dtype)
            vp = torch.randn((nb, bl, kh, hd), generator=gen,
                             device=dev).to(dtype)

            def kernel():
                return paged.paged_decode_attention(q, kp, vp, table, pos,
                                                    block_len=bl)

            def plain():
                return paged.paged_decode_attention_plain(
                    q, kp, vp, table, pos, block_len=bl)
            got, want = kernel(), plain()
            again = kernel()
            torch.cuda.synchronize()
            ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
            ok = ok and torch.equal(got, again)       # bitwise repeatable
            # Work this run's data needs: slot b reads its K and V rows of
            # positions [0, pos[b]] for each kv head once.
            n_pos = [int(p) + 1 for p in pos.tolist()]
            es = q.element_size()
            bts = (2 * sum(n_pos) * kh * hd * es + 2 * q.numel() * es
                   + 4 * table.numel() + 4 * pos.numel())
            b_ms, b_by = bound(bts, 4.0 * h * hd * sum(n_pos), dtype)
            # Yardstick: the same rows as a contiguous (B, H, S, D) cache.
            j = torch.arange(mb * bl, device=dev)
            rows = table.long()[:, j // bl] * bl + j % bl
            kd, vd = (pg.reshape(nb * bl, kh, hd)[rows].transpose(1, 2)
                      .repeat_interleave(h // kh, dim=1).contiguous()
                      for pg in (kp, vp))
            mask = (j[None, :] <= pos.long()[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]
            sdpa_ms = device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q4, kd, vd, attn_mask=mask))
            split_len, splits = paged.split_plan(b, h, kh, hd, mb * bl, dtype)
            case = dict(
                case=name, shape=dict(b=b, h=h, kh=kh, d=hd, bl=bl, mb=mb,
                                      nb=nb),
                pos=pos.tolist(), dtype=str(dtype).split(".")[-1],
                split_len=split_len, splits=splits,
                max_abs_err=ea, max_rel_err=er, ok=ok, ms=device_ms(kernel),
                wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain),
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                dense_sdpa_ms=sdpa_ms)
            print(json.dumps({"paged_decode_case": case}), flush=True)
            cases.append(case)
            if name in ("engine", "long"):
                combine_cases.append(check_paged_combine(
                    paged, q, kp, vp, table, pos, name))
            del kd, vd, kp, vp
    return cases, combine_cases


def check_paged_combine(paged, q, kp, vp, table, pos, name) -> dict:
    """The combine kernel against its plain version on the split kernel's
    partials of one paged decode case (launches made here are checks, not
    main-path launches)."""
    acc, ml = paged.paged_decode_partials(q, kp, vp, table, pos,
                                          block_len=KV_BLOCK_LEN)
    got = paged.paged_decode_combine(acc, ml, q.dtype)
    want = paged.paged_decode_combine_plain(acc, ml, q.dtype)
    ea, er, ok = errors(got, want, BF16_ATOL, BF16_RTOL)
    # Bytes: every live split's partial row once (this run's data), the
    # statistics and the output.
    splits, b, h, d = acc.shape
    live = int((ml[..., 1] > 0).sum())
    bts = live * d * 4 + ml.numel() * 4 + got.numel() * got.element_size()
    b_ms, b_by = bound(bts, 3.0 * live * d, q.dtype)
    return dict(case=name, shape=dict(splits=splits, b=b, h=h, d=d),
                live_partials=live, dtype=str(q.dtype).split(".")[-1],
                max_abs_err=ea, max_rel_err=er, ok=ok,
                ms=device_ms(lambda: paged.paged_decode_combine(acc, ml,
                                                                q.dtype)),
                wrapper_ms=wrapper_ms(lambda: paged.paged_decode_combine(
                    acc, ml, q.dtype)),
                plain_ms=device_ms(lambda: paged.paged_decode_combine_plain(
                    acc, ml, q.dtype)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def ring_errors(got: torch.Tensor, want: torch.Tensor):
    """`errors` at the ring schedule's limits (RING_RTOL, and
    RING_ATOL_OF_MAX times want's largest magnitude), with the largest
    error as a share of that magnitude."""
    top = float(want.detach().abs().max())
    ea, er, ok = errors(got.detach(), want.detach(), RING_ATOL_OF_MAX * top,
                        RING_RTOL)
    return ea, er, ok, ea / max(top, 1e-30)


def check_lse_entry(dev, flash, shape, dtype) -> dict:
    """`flash_attention_lse` (O and LSE) and its backward with a nonzero
    LSE cotangent (`flash_attention_backward`'s g_lse) against the plain
    versions on the same inputs."""
    gen = torch.Generator(device=dev).manual_seed(24)
    b, s, h, d = shape

    def randn(*sh, dt=dtype):
        return torch.randn(sh, generator=gen, device=dev).to(dt)
    q, k, v, do = (randn(*shape) for _ in range(4))
    g_lse = randn(b, h, s, dt=torch.float32)
    o, lse = flash.flash_attention_lse(q, k, v, True)
    want_o, want_lse = flash.flash_attention_plain(q, k, v, True,
                                                   return_lse=True)
    tol = (dict(atol=BF16_ATOL, rtol=BF16_RTOL) if dtype == torch.bfloat16
           else dict(atol=1e-5, rtol=1e-5))
    ea_o, _, ok_o = errors(o, want_o, **tol)
    ea_l, _, ok_l = errors(lse, want_lse, LSE_ATOL, 0.0)
    grads = flash.flash_attention_backward(q, k, v, o, lse, do, True,
                                           g_lse=g_lse)
    wants = flash.flash_attention_backward_plain(q, k, v, o, lse, do, True,
                                                 g_lse=g_lse)
    bwd = {}
    for name, got, want in zip(("dq", "dk", "dv"), grads, wants):
        ea, er, ok = bwd_errors(got, want)
        if not ok:
            fail(f"flash_attention_lse backward {name} at {shape} "
                 f"{dtype}: max abs err {ea}, rel {er}")
        bwd[name] = ea
    # The fold is live: the LSE cotangent moves dq.
    dq0 = flash.flash_attention_backward(q, k, v, o, lse, do, True)[0]
    if torch.equal(dq0, grads[0]):
        fail("flash_attention_lse: the LSE cotangent changed nothing")
    if not (ok_o and ok_l):
        fail(f"flash_attention_lse at {shape} {dtype}: O err {ea_o}, LSE "
             f"err {ea_l}")
    return dict(shape=list(shape), dtype=str(dtype).split(".")[-1],
                o_max_abs_err=ea_o, lse_max_abs_err=ea_l,
                bwd_max_abs_err=bwd)


def ring_schedule(ring, shards, sp: int) -> list:
    """The ring's per-step block function (`ring_step`) for each of `sp`
    virtual ranks in one process, the shift replaced by indexing into the
    held (q, k, v) shards: each rank's output shard."""
    q, k, v = shards
    outs = []
    for r in range(sp):
        part = ring.init_partials(q[r])
        for step in range(sp):
            src = (r - step) % sp
            part = ring.ring_step(q[r], k[src], v[src], part, r, src, True,
                                  True)
        outs.append(ring.finish(part, q[r].dtype))
    return outs


def masked_tail_zeros(flash, q, k, v, do, sp: int) -> list:
    """Each sp rank's own dK and dV of the whole K/V (the backward
    kernels called at its queries' global offset r * S/sp, Sk = S): the
    count of nonzero entries on the rows past its last query (want 0),
    and on the rows before (want > 0), for every rank with such a tail."""
    s = q.shape[1] // sp
    out = []
    for r in range(sp - 1):
        qr = q[:, r * s:(r + 1) * s].contiguous()
        dor = do[:, r * s:(r + 1) * s].contiguous()
        o, lse = flash.flash_attention(qr, k, v, True, r * s, 0,
                                       return_lse=True)
        _, dk, dv = flash.flash_attention_backward(qr, k, v, o, lse, dor,
                                                   True, r * s, 0)
        end = (r + 1) * s
        out.append(dict(
            rank=r, tail_rows=q.shape[1] - end,
            tail_nonzero=int(torch.count_nonzero(dk[:, end:]))
            + int(torch.count_nonzero(dv[:, end:])),
            head_nonzero=int(torch.count_nonzero(dk[:, :end]))
            + int(torch.count_nonzero(dv[:, :end]))))
        del o, lse, dk, dv
    return out


def run_ring(dev, flash, ring, kernels, card: str) -> dict:
    """The ring phase (see RING_SP): the LSE entry point against its plain
    versions, then the ring schedule at seq RING_SEQ against one
    whole-sequence flash_attention_train call, forward and backward
    (autograd through the blocks), held at RING_RTOL / RING_ATOL_OF_MAX;
    and the gathered form (`gathered_attention` on RING_SP virtual ranks
    of a ThreadGroup, one backward over their losses) against both, with
    each rank's masked K/V tail held to exact zero dK and dV
    (`masked_tail_zeros`). Launches are one forward and backward of the
    schedule (the phase's), of the gathered form (`gathered`: forward by
    rank, backward) and of the single call (apart); ms each over eager
    calls between CUDA events, in turns; the peak GB each allocates above
    what is allocated when it starts (the inputs and the phase's other
    tensors)."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
    out = {"card": card, "lse_entry": [check_lse_entry(dev, flash, sh, dt)
                                       for sh, dt in LSE_SHAPES]}
    gen = torch.Generator(device=dev).manual_seed(25)
    launches, single_launches, cases = {}, {}, []
    gathered_launches = collections.Counter()
    for h, d in RING_HEADS:
        shape = (RING_BATCH, RING_SEQ, h, d)
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        s = RING_SEQ // RING_SP

        def shards(t):
            return [t[:, r * s:(r + 1) * s].contiguous().requires_grad_(True)
                    for r in range(RING_SP)]
        qs, ks, vs = shards(q), shards(k), shards(v)
        leaves = qs + ks + vs
        dos = [t.detach() for t in shards(do)]

        def ring_run():
            outs = ring_schedule(ring, (qs, ks, vs), RING_SP)
            loss = sum((o.float() * g.float()).sum()
                       for o, g in zip(outs, dos))
            return outs, torch.autograd.grad(loss, leaves)
        qf, kf, vf = (t.detach().clone().requires_grad_(True)
                      for t in (q, k, v))

        def single_run():
            o = flash.flash_attention_train(qf, kf, vf, True)
            return o, torch.autograd.grad(o, (qf, kf, vf), do)
        gq, gk, gv = shards(q), shards(k), shards(v)
        g_leaves = gq + gk + gv
        group = ThreadGroup(RING_SP)
        idents = [None] * RING_SP

        def gathered_rank(r):
            idents[r] = threading.get_ident()
            return ring.gathered_attention(gq[r], gk[r], gv[r],
                                           group.comm(r), True)

        def gathered_run():
            outs = on_thread_group(group, RING_SP, gathered_rank,
                                   "ring gathered")
            loss = sum((o.float() * g.float()).sum()
                       for o, g in zip(outs, dos))
            return outs, torch.autograd.grad(loss, g_leaves)
        if not ring.ring_uses_flash(qs[0], ks[0], True):
            fail(f"ring shards {tuple(qs[0].shape)} miss the flash gate")
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        outs, grads = ring_run()
        torch.cuda.synchronize()
        ring_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        for name, n in kernels.launches.items():
            launches[name] = launches.get(name, 0) + n
        case_launches = dict(kernels.launches)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        o_single, g_single = single_run()
        torch.cuda.synchronize()
        single_peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
        for name, n in kernels.launches.items():
            single_launches[name] = single_launches.get(name, 0) + n
        case_single = dict(kernels.launches)
        with rank_launches(kernels) as by_rank:
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            g_outs, g_grads = gathered_run()
            torch.cuda.synchronize()
            gathered_peak = (torch.cuda.max_memory_allocated(dev)
                             - base) / 1e9
            g_fwd = [dict(by_rank.by_thread[i]) for i in idents]
            g_total = {k: v for k, v in by_rank.items() if v}
        fwd_sum = sum_counts(g_fwd)
        g_bwd = {k: v - fwd_sum.get(k, 0) for k, v in g_total.items()
                 if v - fwd_sum.get(k, 0)}
        gathered_launches.update(g_total)
        stash = flash.stash_bytes(gq[0], k, gq[0]) \
            <= flash.PDS_STASH_LIMIT_BYTES
        dkv = flash.KERNEL_BWD_DKV_STASH if stash else flash.KERNEL_BWD_DKV
        want_fwd = {flash.KERNEL: 1, flash.KERNEL_WGMMA: 1}
        want_bwd = {flash.KERNEL_BWD_DQ: RING_SP,
                    flash.KERNEL_BWD_DQ_WGMMA: RING_SP, dkv: RING_SP,
                    WGMMA_COUNTERS[dkv]: RING_SP}
        if any(f != want_fwd for f in g_fwd) or g_bwd != want_bwd:
            fail(f"ring gathered at {shape}: forward launches by rank "
                 f"{g_fwd}, backward {g_bwd}; want {want_fwd} a rank and "
                 f"{want_bwd}")
        tails = masked_tail_zeros(flash, q, k, v, do, RING_SP)
        for t in tails:
            if t["tail_nonzero"] or not t["head_nonzero"]:
                fail(f"ring gathered at {shape}: rank {t['rank']}'s dK/dV "
                     f"has {t['tail_nonzero']} nonzero entries past its "
                     f"last query ({t['head_nonzero']} before)")
        errs = {}
        got = {"o": torch.cat(outs, dim=1)}
        for i, name in enumerate(("dq", "dk", "dv")):
            got[name] = torch.cat(grads[i * RING_SP:(i + 1) * RING_SP], dim=1)
        want = dict(zip(("o", "dq", "dk", "dv"), (o_single, *g_single)))
        for name in got:
            ea, er, ok, of_max = ring_errors(got[name], want[name])
            errs[name] = dict(max_abs_err=ea, max_rel_err=er,
                              err_of_max=of_max)
            if not ok:
                fail(f"ring schedule {name} at {shape} against the single "
                     f"call: max abs err {ea}, rel {er}")
        gathered = {"o": torch.cat(g_outs, dim=1)}
        for i, name in enumerate(("dq", "dk", "dv")):
            gathered[name] = torch.cat(
                g_grads[i * RING_SP:(i + 1) * RING_SP], dim=1)
        g_errs = {}
        for against, ref in (("single", want), ("ring", got)):
            for name in gathered:
                ea, er, ok, of_max = ring_errors(gathered[name], ref[name])
                g_errs[f"{name}_vs_{against}"] = dict(
                    max_abs_err=ea, max_rel_err=er, err_of_max=of_max)
                if not ok:
                    fail(f"ring gathered {name} at {shape} against the "
                         f"{against}: max abs err {ea}, rel {er}")
        del outs, grads, o_single, g_single, got, want, g_outs, g_grads
        del gathered
        ms = {"ring": [], "single": [], "gathered": []}
        runs = {"ring": ring_run, "single": single_run,
                "gathered": gathered_run}
        for which in ("ring", "single", "gathered", "gathered", "single",
                      "ring"):
            ms[which].append(wrapper_ms(runs[which], iters=3, warmup=1))
        # Causal attention forward and backward (3.5x the forward's 2 * 2
        # * B * H * S^2 * D / 2 operations); q, k, v, dO read and O, dQ,
        # dK, dV written once.
        flops = 3.5 * 2 * RING_BATCH * h * RING_SEQ ** 2 * d
        bts = 8 * q.numel() * q.element_size()
        bound_ms, bound_by = bound(bts, flops)
        cases.append(dict(
            shape=list(shape), shards=RING_SP, errors=errs,
            launches=case_launches, single_launches=case_single,
            ms_ring=ms["ring"], ms_single=ms["single"],
            ratio=sum(ms["ring"]) / sum(ms["single"]), bound_ms=bound_ms,
            bound_by=bound_by, peak_gb_above_inputs_ring=ring_peak,
            peak_gb_above_inputs_single=single_peak,
            gathered=dict(
                errors=g_errs, stash=stash,
                launches_forward_by_rank=g_fwd, launches_backward=g_bwd,
                masked_tail=tails, ms=ms["gathered"],
                ratio_to_single=sum(ms["gathered"]) / sum(ms["single"]),
                ratio_to_ring=sum(ms["gathered"]) / sum(ms["ring"]),
                peak_gb_above_inputs=gathered_peak)))
        del q, k, v, do, qs, ks, vs, leaves, dos, qf, kf, vf
        del gq, gk, gv, g_leaves, group
        torch.cuda.empty_cache()
    rows = (flash.KERNEL, flash.KERNEL_BWD_DQ, flash.KERNEL_BWD_DKV_STASH,
            flash.KERNEL_BWD_DKV)
    for name in rows:
        if launches.get(name, 0) + single_launches.get(name, 0) <= 0:
            fail(f"ring phase: {name} never launched")
    for name in rows[:3]:
        if launches.get(name, 0) <= 0:
            fail(f"ring schedule: {name} never launched")
    for name in rows:
        if gathered_launches.get(name, 0) <= 0:
            fail(f"ring gathered: {name} never launched")
    out.update(cases=cases, launches=launches,
               gathered=dict(launches=dict(gathered_launches)),
               single_call_launches=single_launches,
               tolerance=dict(rtol=RING_RTOL, atol_of_max=RING_ATOL_OF_MAX,
                              lse_atol=LSE_ATOL))
    return out


def check_off_path_shapes(dev, rms, flash) -> dict:
    """Shapes no main path gives the kernels, which the JAX package
    computes: RMSNorm rows past the register-resident layouts (the wide-row
    bodies; the forward's first widths past 2048 16-byte vectors, the
    backward's past 1024), and flash attention forward and backward at
    head_dim 12 (zero-padded to 16 by the wrapper) and 640 (the
    column-sliced bodies), bf16 and f32, each against its plain version."""
    gen = torch.Generator(device=dev).manual_seed(11)

    def randn(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    tol = {torch.bfloat16: (BF16_ATOL, BF16_RTOL), torch.float32: (1e-5, 1e-5)}
    out = {"rms_norm": [], "flash_attention": []}
    for dtype, d in ((torch.bfloat16, 16392), (torch.float32, 8196),
                     (torch.bfloat16, 8200), (torch.float32, 4100)):
        x, dy = randn(6, d, dtype=dtype), randn(6, d, dtype=dtype)
        w = 1.0 + 0.1 * randn(d, dtype=torch.float32)
        fa, fr, fok = errors(rms.rms_norm(x, w), rms.rms_norm_plain(x, w),
                             *tol[dtype])
        dx, dw = rms.rms_norm_backward(x, w, dy)
        want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
        xa, _, xok = bwd_errors(dx, want_dx)
        wa, _, wok = bwd_errors(dw, want_dw)
        repeat = torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw)
        out["rms_norm"].append(dict(
            shape=[6, d], dtype=str(dtype).split(".")[-1], fwd_max_abs_err=fa,
            dx_max_abs_err=xa, dw_max_abs_err=wa, dw_repeat=repeat,
            ok=fok and xok and wok and repeat))
    for dtype in (torch.bfloat16, torch.float32):
        for b, sq, sk, h, d, q_off in ((2, 40, 40, 2, 12, 0),
                                       (1, 70, 90, 2, 640, 20)):
            q, k, v, do = (randn(b, n, h, d, dtype=dtype)
                           for n in (sq, sk, sk, sq))
            o, lse = flash.flash_attention(q, k, v, True, q_off, 0,
                                           return_lse=True)
            want = flash.flash_attention_plain(q, k, v, True, q_off, 0)
            fa, _, fok = errors(o, want, *tol[dtype])
            grads = flash.flash_attention_backward(q, k, v, o, lse, do, True,
                                                   q_off, 0)
            wants = flash.flash_attention_backward_plain(q, k, v, o, lse, do,
                                                         True, q_off, 0)
            bwd = [bwd_errors(g, wt) for g, wt in zip(grads, wants)]
            out["flash_attention"].append(dict(
                shape=dict(b=b, sq=sq, sk=sk, h=h, d=d), q_offset=q_off,
                dtype=str(dtype).split(".")[-1], fwd_max_abs_err=fa,
                bwd_max_abs_err={n: e[0] for n, e in
                                 zip(("dq", "dk", "dv"), bwd)},
                ok=fok and all(e[2] for e in bwd)))
    for name, cases in out.items():
        for c in cases:
            if not c["ok"]:
                fail(f"{name} at a shape off the main paths disagrees with "
                     f"its plain version: {c}")
    return out


# ---------------------------------------------------------------------------
# Phase 2b: the training kernels against their plain versions
# ---------------------------------------------------------------------------


def library_bwd_ms(forward, inputs, iters: int = 10) -> float:
    """Milliseconds per backward of one PyTorch call (the yardstick): eager
    torch.autograd.grad on a retained graph, timed with CUDA events."""
    out = forward(*inputs)
    g = torch.randn_like(out)
    return wrapper_ms(lambda: torch.autograd.grad(out, inputs, g,
                                                  retain_graph=True),
                      iters=iters, warmup=2)


def rms_norm_bwd_library_ms(x, w, dy, **it) -> float:
    """Device ms of the one PyTorch call F.rms_norm's backward runs
    (`aten._fused_rms_norm_backward`: dx and dw from x, dy and the saved
    rstd), taken as the kernels are (`device_ms`)."""
    d = x.shape[-1]
    _, rstd = torch.ops.aten._fused_rms_norm(x, [d], w, 1e-6)
    return device_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
        dy, x, [d], rstd, w, [True, True]), **it)


def check_train_kernels(dev, rms, rope, flash, attn_mod, out: dict) -> dict:
    """The backward kernels (and the RoPE VJP) at the trainer's shapes, a
    stash-path shape and small ragged shapes, in bf16 and f32; adds cases
    to `out`."""
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    b, s, d = TRAIN_BATCH, TRAIN_DIMS["seq_len"], TRAIN_DIMS["d_model"]
    h = TRAIN_DIMS["n_heads"]
    hd = d // h

    # RMSNorm forward and backward: the trainer's (B*S, D) rows in bf16
    # with f32 weights, then smaller and ragged shapes.
    cases = []
    for rows, width, dt, wdt in ((b * s, d, bf16, f32), (600, d, f32, f32),
                                 (3, 203, bf16, bf16)):
        big = rows * width > 1 << 22
        x, dy = randn(rows, width, dtype=dt), randn(rows, width, dtype=dt)
        w = (1.0 + 0.1 * randn(width, dtype=f32)).to(wdt)
        dx, dw = rms.rms_norm_backward(x, w, dy)
        want_dx, want_dw = rms.rms_norm_backward_plain(x, w, dy)
        ea, er, ok = bwd_errors(dx, want_dx)
        ea_w, er_w, ok_w = bwd_errors(dw, want_dw)
        repeat = bool(torch.equal(rms.rms_norm_backward(x, w, dy)[1], dw))
        es, ws = x.element_size(), w.element_size()
        b_ms, b_by = bound(3 * x.numel() * es + 2 * width * ws,
                           10.0 * x.numel(), dt)
        it = dict(iters=5, replays=4) if big else {}
        cases.append(dict(
            case="train" if big else "small", shape=[rows, width],
            dtype=str(dt).split(".")[-1], w_dtype=str(wdt).split(".")[-1],
            max_abs_err=max(ea, ea_w), max_rel_err=max(er, er_w),
            dw_max_abs_err=ea_w, ok=ok and ok_w and repeat,
            dw_bitwise_repeatable=repeat,
            ms=device_ms(lambda: rms.rms_norm_backward(x, w, dy), **it),
            wrapper_ms=wrapper_ms(lambda: rms.rms_norm_backward(x, w, dy)),
            plain_ms=device_ms(lambda: rms.rms_norm_backward_plain(x, w, dy),
                               **it),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=rms_norm_bwd_library_ms(x, w.to(dt), dy, **it),
            library_eager_ms=library_bwd_ms(
                lambda a, ww: torch.nn.functional.rms_norm(
                    a, (width,), ww, 1e-6),
                (x.detach().requires_grad_(),
                 w.to(dt).detach().requires_grad_()))))
        if big:      # the forward kernel at the trainer's rows too; and
            # what the card's memory gives for each direction's bytes
            # through one PyTorch call: `torch.add` (2 in, 1 out), `copy_`
            o = torch.empty_like(x)
            cases[-1]["add_ms"] = device_ms(
                lambda: torch.add(x, dy, out=o), **it)
            ea, er, okf = errors(rms.rms_norm(x, w), rms.rms_norm_plain(x, w),
                                 BF16_ATOL, BF16_RTOL)
            fb_ms, fb_by = bound(2 * x.numel() * es + width * ws,
                                 4.0 * x.numel(), dt)
            out["rms_norm"].append(dict(
                case="train_fwd", shape=[rows, width], dtype="bfloat16",
                max_abs_err=ea, max_rel_err=er, ok=okf,
                ms=device_ms(lambda: rms.rms_norm(x, w), **it),
                wrapper_ms=wrapper_ms(lambda: rms.rms_norm(x, w)),
                plain_ms=device_ms(lambda: rms.rms_norm_plain(x, w), **it),
                bound_ms=fb_ms, bound_by=fb_by,
                library_ms=device_ms(lambda: torch.nn.functional.rms_norm(
                    x, (width,), w.to(dt), 1e-6), **it),
                copy_ms=device_ms(lambda: o.copy_(x), **it)))
            del o
        del x, dy, dx, want_dx
    out["rms_norm_bwd"] = cases

    # RoPE VJP: the same kernel with -sin (its sign flag), at the trainer's
    # q shape, on the in-place views of the table; bit for bit.
    freqs = attn_mod.rope_frequencies(hd, s, 10000.0, dev)
    c, sn = freqs[..., 0], freqs[..., 1]
    neg = -sn
    for dt in (bf16, f32):
        x = randn(b, s, h, hd, dtype=dt).requires_grad_()
        g = randn(b, s, h, hd, dtype=dt)
        (got,) = torch.autograd.grad(rope.rope_rotate(x, c, sn), (x,), g)
        want = rope.rope_rotate_plain(g, c, neg)
        ea, er, _ = bwd_errors(got, want)
        ok = bool(torch.equal(got, want))
        b_ms, b_by = bound(2 * g.numel() * g.element_size()
                           + 2 * c.numel() * 4, 3.0 * g.numel(), dt)
        it = dict(iters=10, replays=3)

        def vjp():
            return rope.rope_rotate_forward(g, c, sn, inverse=True)
        out["rope"].append(dict(
            case="train_vjp", shape=list(g.shape), offset=0,
            dtype=str(dt).split(".")[-1], max_abs_err=ea, max_rel_err=er,
            ok=ok, ms=device_ms(vjp, **it),
            wrapper_ms=wrapper_ms(vjp, iters=10),
            plain_ms=device_ms(lambda: rope.rope_rotate_plain(g, c, neg),
                               **it),
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
        del x, g, got, want

    # Flash backward: the trainer's shape (recompute dK/dV), the stash
    # shape (batch 4), the trainer's sequence and head_dim in f32 (batch 1),
    # the flagship microbatch and its f32 gate on the flat (B*H, S, 1, D)
    # view the t-layout path launches on, and small ragged shapes; the dQ
    # kernel (with its stash except at the trainer's shape) and both dK/dV
    # kernels at each, against the plain versions of ops/flash_attention.py.
    dq_cases, dkv_cases, st_cases = [], [], []
    for name, (bb, ss, hh, dd), dt, big in (
            ("train", (b, s, h, hd), bf16, True),
            ("stash", (STASH_BATCH, s, h, hd), bf16, True),
            ("seq2048_f32", (1, s, h, hd), f32, True),
            ("ragged", (2, 100, 3, 64), bf16, False),
            ("ragged_f32", (2, 77, 2, 256), f32, False),
            ("flagship", (FLAGSHIP_MICRO * 4, s, 1, 512), bf16, True),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH * 4, 512, 1, 512),
             f32, True),
            ("ragged_d512", (2, 37, 1, 512), bf16, False)):
        q, k, v, do = (randn(bb, ss, hh, dd, dtype=dt) for _ in range(4))
        o, lse = flash.flash_attention(q, k, v, True, return_lse=True)
        delta = flash.backward_delta(o, do)
        use_stash = name != "train"
        args = (q, k, v, do, lse, delta)
        with torch.no_grad():
            want_dq, want_p, want_ds = flash.flash_bwd_dq_plain(
                *args, stash=use_stash)
            want_dk, want_dv = flash.flash_bwd_dkv_plain(*args)
        dq, p_st, ds_st = flash.flash_bwd_dq(*args, stash=use_stash)
        dk_r, dv_r = flash.flash_bwd_dkv(*args)
        e_dq, e_dkv, e_st = (dict(max_abs_err=0.0, max_rel_err=0.0, ok=True)
                             for _ in range(3))

        def acc(entry, got, want):
            ea, er, ok = bwd_errors(got, want)
            entry["max_abs_err"] = max(entry["max_abs_err"], ea)
            entry["max_rel_err"] = max(entry["max_rel_err"], er)
            entry["ok"] = entry["ok"] and ok
        acc(e_dq, dq, want_dq)
        acc(e_dkv, dk_r, want_dk)
        acc(e_dkv, dv_r, want_dv)
        if use_stash:
            # The stash itself (zeros past the diagonal included), then
            # dK/dV from it.
            acc(e_dq, p_st, want_p)
            acc(e_dq, ds_st, want_ds)
            dk_s, dv_s = flash.flash_bwd_dkv_from_stash(q, k, v, do, p_st,
                                                        ds_st)
            acc(e_st, dk_s, want_dk)
            acc(e_st, dv_s, want_dv)
            del dk_s, dv_s
        del want_dq, want_p, want_ds, want_dk, want_dv, dk_r, dv_r, dq
        # Work this run's data needs: query row i sees keys [0, i].
        vis = bb * hh * ss * (ss + 1) // 2
        es = q.element_size()
        io_bytes = 4 * q.numel() * es + 2 * 4 * bb * hh * ss
        stash_w = 2 * bb * hh * ss * ss * es if use_stash else 0
        shape = dict(b=bb, s=ss, h=hh, d=dd)
        it = dict(iters=2, replays=2) if big else {}
        wit = 3 if big else 50
        lib = None
        if dt == bf16:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            lib = library_bwd_ms(
                lambda a, bk, c_: torch.nn.functional
                .scaled_dot_product_attention(a, bk, c_, is_causal=True),
                (qt, kt, vt), iters=5 if big else 20)
            del qt, kt, vt

        def case(entry, kernel, fn, plain, flops, bts):
            b_ms, b_by = bound(bts, flops, dt)
            entry.update(case=name, shape=shape, dtype=str(dt).split(".")[-1],
                         **flash.bwd_body(kernel, dd, dt),
                         rtol=BWD_RTOL[dt], atol_of_rms=BWD_ATOL_OF_RMS[dt],
                         ms=device_ms(fn, **it), wrapper_ms=wrapper_ms(
                             fn, iters=wit, warmup=2),
                         plain_ms=device_ms(plain, **it), bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib,
                         library_is="the whole backward (dQ, dK, dV)"
                         if lib is not None else None)
            return entry
        dq_cases.append(case(
            e_dq, flash.KERNEL_BWD_DQ,
            lambda: flash.flash_bwd_dq(*args, stash=use_stash),
            lambda: flash.flash_bwd_dq_plain(*args, stash=use_stash),
            3 * 2.0 * dd * vis, io_bytes + stash_w))
        if use_stash:     # what the recompute path's dQ costs at this shape
            e_dq["ms_without_stash"] = device_ms(
                lambda: flash.flash_bwd_dq(*args), **it)
        dkv_cases.append(case(
            e_dkv, flash.KERNEL_BWD_DKV, lambda: flash.flash_bwd_dkv(*args),
            lambda: flash.flash_bwd_dkv_plain(*args),
            4 * 2.0 * dd * vis, io_bytes + 2 * q.numel() * es))
        if use_stash:
            st_cases.append(case(
                e_st, flash.KERNEL_BWD_DKV_STASH,
                lambda: flash.flash_bwd_dkv_from_stash(
                    q, k, v, do, p_st, ds_st),
                lambda: flash.flash_bwd_dkv_from_stash_plain(
                    q, k, v, do, p_st, ds_st),
                2 * 2.0 * dd * vis, 4 * q.numel() * es + 2 * vis * es))
        del q, k, v, do, o, lse, delta, p_st, ds_st, args
        torch.cuda.empty_cache()
    out["flash_attention_bwd_dq"] = dq_cases
    out["flash_attention_bwd_dkv"] = dkv_cases
    out["flash_attention_bwd_dkv_stash"] = st_cases

    # The forward kernel at the trainer's shape (it runs 8 times a step) and
    # at the flagship's flat view (3 times a microbatch).
    for name, (bb, hh, dd) in (
            ("train_fwd", (b, h, hd)),
            ("flagship_fwd", (FLAGSHIP_MICRO * 4, 1, 512))):
        q, k, v = (randn(bb, s, hh, dd) for _ in range(3))
        ea, er, ok = errors(flash.flash_attention(q, k, v, True),
                            flash.flash_attention_plain(q, k, v, True),
                            BF16_ATOL, BF16_RTOL)
        vis = bb * hh * s * (s + 1) // 2
        fb_ms, fb_by = bound(4 * q.numel() * 2, 4.0 * dd * vis)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        it = dict(iters=2, replays=2)
        out["flash_attention"].append(dict(
            case=name, shape=dict(b=bb, sq=s, sk=s, h=hh, kh=hh, d=dd),
            q_offset=0, dtype="bfloat16",
            **flash_body(flash, q.dtype, dd), max_abs_err=ea,
            max_rel_err=er, ok=ok,
            ms=device_ms(lambda: flash.flash_attention(q, k, v, True), **it),
            wrapper_ms=wrapper_ms(lambda: flash.flash_attention(q, k, v, True),
                                  iters=3, warmup=1),
            plain_ms=device_ms(
                lambda: flash.flash_attention_plain(q, k, v, True), **it),
            bound_ms=fb_ms, bound_by=fb_by,
            library_ms=device_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), **it)))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    for name, cs in out.items():
        for c in cs:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def ulp_errors(got: torch.Tensor, want: torch.Tensor):
    """Max abs difference of two bf16 tensors, and whether every entry is
    within one bf16 ulp (2^-7 of the value) of want's, or within the floor
    of CE_STAT_RTOL's note for entries near zero."""
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail("kernel output has non-finite values")
    diff = (g - w).abs()
    rms_w = float(torch.linalg.vector_norm(w)) / max(1, w.numel()) ** 0.5
    floor = BWD_ATOL_OF_RMS[torch.bfloat16] * rms_w
    return float(diff.max()), bool((diff <= w.abs() / 128 + floor).all())


def check_flagship_kernels(dev, rope, fused_ce, attn_mod, out: dict) -> dict:
    """The t-layout RoPE pair and the fused CE kernels at the flagship's
    shapes (microbatch 8 x 2048 tokens, 4 heads of 512, vocab 32768), the
    f32 gate's and small ragged ones; adds cases to `out`."""
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # RoPE into and out of the flat layout: bit for bit, as `rope` is.
    seq = TRAIN_DIMS["seq_len"]
    fwd_cases, inv_cases = [], []
    for name, (bb, ss, hh, dd), dt in (
            ("flagship", (FLAGSHIP_MICRO, seq, 4, 512), bf16),
            ("flagship_f32", (FLAGSHIP_MICRO, seq, 4, 512), f32),
            ("ragged", (3, 5, 2, 24), bf16)):
        fr = attn_mod.rope_frequencies(dd, ss, 10000.0, dev)
        c, sn = fr[..., 0], fr[..., 1]         # read in place, as on the path
        x = randn(bb, ss, hh, dd, dtype=dt)
        g = randn(bb * hh, ss, dd, dtype=dt)
        es = x.element_size()
        b_ms, b_by = bound(2 * x.numel() * es + 2 * c.numel() * 4,
                           3.0 * x.numel(), dt)
        it = dict(iters=10, replays=3)
        for lst, fn, plain in (
                (fwd_cases, lambda: rope.rope_rotate_t_forward(x, c, sn),
                 lambda: rope.rope_rotate_t_plain(x, c, sn)),
                (inv_cases, lambda: rope.rope_rotate_t_inverse(g, c, sn, hh),
                 lambda: rope.rope_rotate_t_inv_plain(g, c, sn, hh))):
            got, want = fn(), plain()
            lst.append(dict(
                case=name, shape=[bb, ss, hh, dd], dtype=str(dt).split(".")[-1],
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ok=bool(torch.equal(got, want)), ms=device_ms(fn, **it),
                wrapper_ms=wrapper_ms(fn, iters=10), plain_ms=device_ms(
                    plain, **it), bound_ms=b_ms, bound_by=b_by,
                library_ms=None))
        del x, g
    out["rope_t"], out["rope_t_inv"] = fwd_cases, inv_cases

    # Fused CE: the flagship microbatch, the f32 gate's rows, ragged N and
    # V (at D 128 and at the full D) and N < 64 with V 8.
    fwd_cases, bwd_cases = [], []
    for name, (n, d, v), dt in (
            ("flagship", (FLAGSHIP_MICRO * seq, 2048, 32768), bf16),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH * 512, 2048, 32768),
             f32),
            ("ragged", (300, 128, 264), bf16),
            ("ragged_full_d", (300, 2048, 264), bf16),
            ("tiny", (8, 256, 8), bf16)):
        h2 = randn(n, d, dtype=dt)
        head = (0.05 * randn(d, v, dtype=f32)).to(dt)
        t1 = torch.randint(0, v, (n,), generator=gen, device=dev)
        lse, gold, stash = fused_ce.fused_ce_forward(h2, head, t1)
        w_lse, w_gold, w_stash = fused_ce.fused_ce_forward_plain(h2, head, t1)
        rt = CE_STAT_RTOL[dt]
        ea, er, ok = errors(lse, w_lse, rt, rt)
        ea_g, er_g, ok_g = errors(gold, w_gold, rt, rt)
        ea_s, ok_s = ulp_errors(stash, w_stash)
        scale = torch.tensor([1.0 / n], device=dev)
        dlg, dh = fused_ce.fused_ce_backward(w_stash, head, w_lse, t1, scale)
        w_dlg, w_dh = fused_ce.fused_ce_backward_plain(w_stash, head, w_lse,
                                                       t1, scale)
        ea_d, ok_d = ulp_errors(dlg, w_dlg)
        ea_h, er_h, ok_h = bwd_errors(dh, w_dh)
        del lse, gold, stash, dlg, dh, w_dlg, w_dh
        big = n * v > 1 << 24
        it = dict(iters=2, replays=2) if big else {}
        wit = 3 if big else 20
        es = h2.element_size()
        shape = dict(n=n, d=d, v=v)
        fb_ms, fb_by = bound(n * d * es + d * v * es + 4 * n + 2 * n * v
                             + 8 * n, 2.0 * n * d * v, dt)
        hl = h2.detach().requires_grad_()
        fwd_body = fused_ce.body_report(fused_ce.KERNEL_FWD, dt)
        bwd_body = fused_ce.body_report(fused_ce.KERNEL_BWD, dt)
        if fwd_body["body"] != fused_ce.ce_body(dt) \
                or bwd_body["body"] != fused_ce.ce_body(dt):
            fail(f"fused CE bodies {fwd_body} / {bwd_body} at {dt}, the "
                 f"rule says {fused_ce.ce_body(dt)}")
        fwd_cases.append(dict(
            case=name, shape=shape, dtype=str(dt).split(".")[-1], **fwd_body,
            max_abs_err=max(ea, ea_g, ea_s), max_rel_err=max(er, er_g),
            lse_max_abs_err=ea, gold_max_abs_err=ea_g,
            stash_max_abs_err=ea_s, stat_rtol=rt, stash_within_one_ulp=ok_s,
            ok=ok and ok_g and ok_s,
            ms=device_ms(lambda: fused_ce.fused_ce_forward(h2, head, t1),
                         **it),
            wrapper_ms=wrapper_ms(
                lambda: fused_ce.fused_ce_forward(h2, head, t1), iters=wit,
                warmup=2),
            plain_ms=device_ms(
                lambda: fused_ce.fused_ce_forward_plain(h2, head, t1), **it),
            bound_ms=fb_ms, bound_by=fb_by,
            library_ms=device_ms(lambda: F.cross_entropy(
                (h2 @ head).float(), t1), **it),
            library_is="two calls: torch.matmul (logits) + F.cross_entropy"))
        bb_ms, bb_by = bound(2 * n * v * 2 + d * v * es + 8 * n
                             + n * d * 2, 2.0 * n * d * v + 5.0 * n * v, dt)
        bwd_cases.append(dict(
            case=name, shape=shape, dtype=str(dt).split(".")[-1], **bwd_body,
            max_abs_err=max(ea_d, ea_h), max_rel_err=er_h,
            dlg_max_abs_err=ea_d, dlg_within_one_ulp=ok_d,
            dh_max_abs_err=ea_h, ok=ok_d and ok_h,
            ms=device_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale), **it),
            wrapper_ms=wrapper_ms(lambda: fused_ce.fused_ce_backward(
                w_stash, head, w_lse, t1, scale), iters=wit, warmup=2),
            plain_ms=device_ms(lambda: fused_ce.fused_ce_backward_plain(
                w_stash, head, w_lse, t1, scale), **it),
            bound_ms=bb_ms, bound_by=bb_by,
            library_ms=library_bwd_ms(
                lambda a: F.cross_entropy((a @ head).float(), t1), (hl,),
                iters=3 if big else 10),
            library_is="backward of torch.matmul + F.cross_entropy (two "
                       "calls) to the hidden, eager"))
        del h2, head, t1, w_lse, w_gold, w_stash, hl
        torch.cuda.empty_cache()
    out["fused_ce_fwd"], out["fused_ce_bwd"] = fwd_cases, bwd_cases
    for name in ("rope_t", "rope_t_inv", "fused_ce_fwd", "fused_ce_bwd"):
        for c in out[name]:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


def check_embed_relayout_kernels(dev, embed, relayout, out: dict) -> dict:
    """The embedding gather at the flagship microbatch (the loss's strided
    tokens[:, :-1] view of 8 x 2049 ids, the bf16 table of V 32768 x D
    2048), a decode step (8 ids), a prefill chunk (1 x 128), the trainer's
    f32 master table (rows rounded to bf16) and an f32 table with repeated
    ids, 0 and V - 1 (the f32 gates'); the relayout pair at the flagship
    microbatch (8, 2048, 4, 512) bf16, the flagship f32 gate's
    (1, 512, 4, 512) and a ragged shape. Each is held to its plain version
    bit for bit; adds cases to `out`."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16, f32 = torch.bfloat16, torch.float32
    F = torch.nn.functional
    v, d = SERVE_DIMS["vocab_size"], SERVE_DIMS["d_model"]
    seq = TRAIN_DIMS["seq_len"]
    master = 0.02 * torch.randn((v, d), generator=gen, device=dev)
    table_bf = master.to(bf16)

    def ids(*shape, high=v):
        return torch.randint(0, high, shape, generator=gen, device=dev)
    repeats = ids(FLAGSHIP_GATE_BATCH, 512, high=64)
    repeats[0, 0], repeats[0, -1] = 0, v - 1
    cases = []
    for name, table, i, dt in (
            ("flagship", table_bf, ids(FLAGSHIP_MICRO, seq + 1)[:, :-1], bf16),
            ("decode", table_bf, ids(NUM_SLOTS), bf16),
            ("prefill", table_bf, ids(1, PREFILL_LEN), bf16),
            ("prefill_chunk32", table_bf, ids(1, STORM_CHUNK_TOKENS), bf16),
            ("train_f32_master", master, ids(TRAIN_BATCH, seq + 1)[:, :-1],
             bf16),
            ("f32_repeats", master, repeats, f32)):
        scale = embed.embed_scale(d, dt)

        def kernel():
            return embed.embed_gather(table, i, scale, dt, True)

        def plain():
            return embed.embed_gather_plain(table, i, scale, dt, True)
        got, want = kernel(), plain()
        n = i.numel()
        b_ms, b_by = bound(n * d * (table.element_size() + got.element_size())
                           + n * i.element_size(), 1.0 * n * d, f32)
        it = dict(iters=10, replays=3) if n * d > 1 << 22 else {}
        cases.append(dict(
            case=name, shape=dict(ids=list(i.shape), v=v, d=d),
            table_dtype=str(table.dtype).split(".")[-1],
            dtype=str(dt).split(".")[-1], scale=scale,
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ok=bool(torch.equal(got, want)), ms=device_ms(kernel, **it),
            wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain, **it),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=device_ms(lambda: F.embedding(i, table), **it),
            library_is="F.embedding (the gather alone)",
            eager_ms=device_ms(lambda: table.to(dt)[i] * scale, **it),
            eager_is="table.to(dtype)[ids] * scale, the model's expression "
                     "before the kernel"))
        del got, want
    out["embed_gather"] = cases

    to_cases, from_cases = [], []
    for name, (b, s, h, dd), dt in (
            ("flagship", (FLAGSHIP_MICRO, seq, 4, 512), bf16),
            ("flagship_gate_f32", (FLAGSHIP_GATE_BATCH, 512, 4, 512), f32),
            ("ragged", (3, 5, 2, 24), bf16)):
        x = torch.randn((b, s, h, dd), generator=gen, device=dev).to(dt)
        g = torch.randn((b * h, s, dd), generator=gen, device=dev).to(dt)
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), 0.0, dt)
        it = dict(iters=10, replays=3) if x.numel() > 1 << 22 else {}
        for lst, kernel, plain, lib in (
                (to_cases, lambda: relayout.to_t_forward(x),
                 lambda: relayout.to_t_layout_plain(x),
                 lambda: x.transpose(1, 2).contiguous()),
                (from_cases, lambda: relayout.from_t_forward(g, b, h),
                 lambda: relayout.from_t_layout_plain(g, b, h),
                 lambda: g.view(b, h, s, dd).transpose(1, 2).contiguous())):
            got, want = kernel(), plain()
            lst.append(dict(
                case=name, shape=[b, s, h, dd], dtype=str(dt).split(".")[-1],
                max_abs_err=float((got.float() - want.float()).abs().max()),
                ok=bool(torch.equal(got, want)), ms=device_ms(kernel, **it),
                wrapper_ms=wrapper_ms(kernel), plain_ms=device_ms(plain, **it),
                bound_ms=b_ms, bound_by=b_by,
                library_ms=device_ms(lib, **it),
                library_is="x.transpose(1, 2).contiguous() (or its inverse)"))
            del got, want
        del x, g
    out["relayout_to_t"], out["relayout_from_t"] = to_cases, from_cases
    del master, table_bf
    torch.cuda.empty_cache()
    for name in ("embed_gather", "relayout_to_t", "relayout_from_t"):
        for c in out[name]:
            if not c["ok"]:
                fail(f"{name} disagrees with its plain version: {c}")
    return out


# ---------------------------------------------------------------------------
# Phase 3: the engines at the serve dims
# ---------------------------------------------------------------------------


def _rope_plain(rope):
    def plain(x, cos, sin, inverse=False):
        return rope.rope_rotate_plain(x, cos, -sin if inverse else sin)
    return plain


def _rope_t_plain(rope):
    def plain(x, cos, sin, heads, to_flat):
        return (rope.rope_rotate_t_plain(x, cos, sin) if to_flat
                else rope.rope_rotate_t_inv_plain(x, cos, sin, heads))
    return plain


@contextlib.contextmanager
def plain_versions(rms, rope, flash):
    """Route the kernel entry points, forward and backward, to their plain
    versions (the reference of this script; the package itself never does
    this)."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (embed, fused_ce,
                                                         relayout)

    def relayout_plain(x, b, h, to_flat):
        return (relayout.to_t_layout_plain(x) if to_flat
                else relayout.from_t_layout_plain(x, b, h))
    names = ((embed, "_embed_gather_cuda", embed.embed_gather_plain),
             (relayout, "_relayout_cuda", relayout_plain),
             (rms, "_rms_norm_cuda", rms.rms_norm_plain),
             (rms, "_rms_norm_backward_cuda", rms.rms_norm_backward_plain),
             (rope, "_rope_rotate_cuda", _rope_plain(rope)),
             (rope, "_rope_t_cuda", _rope_t_plain(rope)),
             (flash, "_flash_attention_cuda", flash.flash_attention_plain),
             (flash, "_flash_attention_backward_cuda",
              flash.flash_attention_backward_plain),
             (fused_ce, "_fused_ce_forward_cuda",
              fused_ce.fused_ce_forward_plain),
             (fused_ce, "_fused_ce_backward_cuda",
              fused_ce.fused_ce_backward_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, plain in names:
        setattr(mod, name, plain)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def prefill_logits(decode, params, cfg, prompt, dev):
    """Last-position logits of `prompt` through forward_cached in
    prefill_len chunks, and the first chunk's full logits."""
    temp = decode.init_cache(cfg, 1, cfg.max_seq, dev)
    first = last = None
    for off in range(0, len(prompt), PREFILL_LEN):
        chunk = torch.as_tensor([prompt[off:off + PREFILL_LEN]], device=dev)
        logits, temp = decode.forward_cached(params, chunk, temp, off, cfg)
        first = logits[0] if first is None else first
        last = logits[0, -1]
    return first, last


def serve_params(dev, tf, serve):
    """The serve dims' config and bf16 params from seed 0 (as the serve
    main builds them), and the seconds the init took."""
    cfg = tf.TransformerConfig(**SERVE_DIMS, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = serve._finish_params(tf.init_params(gen, cfg), cfg, False)
    torch.cuda.synchronize()
    return cfg, params, time.perf_counter() - t0


def run_engine(dev, mods, cfg, params, init_s) -> dict:
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    prompts = engine_prompts(cfg.vocab_size)

    def warmed(**kw):
        return warmed_engine(serving, params, cfg, dev, prompts[0], **kw)
    eng = warmed(watchdog_timeout=WATCHDOG_S)
    capture_ms = eng._graph.capture_ms
    before = eng.metrics_snapshot()["lifetime"]

    kernels.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    engine_launches = dict(kernels.launches)
    m = eng.metrics()
    life = {k: m["lifetime"][k] - before[k]
            for k in ("prefill_chunks", "decode_steps")}
    want = expected_launches(cfg.n_layers, life)
    if engine_launches != want:
        fail(f"engine launches {engine_launches}, its chunks and steps "
             f"need {want}")
    for rid, p in zip(rids, prompts):
        r = eng.result(rid)
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            fail(f"request {rid} ended {r.finish_reason} with "
                 f"{len(r.tokens)} tokens: {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens):
            fail(f"request {rid} produced out-of-range token ids")
        if not all(np.isfinite(r.logprobs)):
            fail(f"request {rid} has non-finite logprobs")
    # The graphed, pipelined engine against the eager, serialized one on
    # the same weights and prompts, greedy and sampled (not counted).
    graphed = [eng.result(r) for r in rids]
    hotpath = dict(check_graphed(eng, "engine"), capture_ms=capture_ms)
    graphed_sampled = transcripts(eng, prompts, SAMPLED_T)
    check_graphed(eng, "engine, sampled")
    hotpath.update(greedy_ms_per_token_p50=decode_p50_ms(graphed),
                   sampled_ms_per_token_p50=decode_p50_ms(graphed_sampled))
    ref = warmed(cuda_graph=False, overlap_commit=False)
    eager = transcripts(ref, prompts)
    eager_m = ref.metrics()
    hold_to_eager(graphed, eager, "engine (greedy)")
    hold_to_eager(graphed_sampled, transcripts(ref, prompts, SAMPLED_T),
                  "engine (sampled)")
    del ref

    # Reference: the same forward with the plain versions in place of the
    # kernels, on the same weights and prompts (not counted as launches).
    first_k, _ = prefill_logits(decode, params, cfg, prompts[0], dev)
    with plain_versions(rms, rope, flash):
        first_p, _ = prefill_logits(decode, params, cfg, prompts[0], dev)
        plain_first = []
        for p in prompts:
            _, last = prefill_logits(decode, params, cfg, p, dev)
            top2 = torch.topk(last, 2).values
            plain_first.append((int(torch.argmax(last)),
                                float(top2[0] - top2[1])))
    if first_k.shape != (PREFILL_LEN, cfg.vocab_size) \
            or not torch.isfinite(first_k).all():
        fail(f"prefill logits shape {tuple(first_k.shape)} or non-finite")
    logits_err = float((first_k - first_p).abs().max())
    if logits_err > LOGITS_ATOL:
        fail(f"first prefill chunk logits differ from the plain path by "
             f"{logits_err} > {LOGITS_ATOL}")
    engine_first = [eng.result(r).tokens[0] for r in rids]
    if engine_first != [t for t, _ in plain_first]:
        fail(f"first tokens differ from the plain path: engine "
             f"{engine_first}, plain {plain_first}")
    del eng
    torch.cuda.empty_cache()
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", num_slots=NUM_SLOTS,
                    prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK),
        requests=len(rids), prompt_lens=[len(p) for p in prompts],
        new_tokens=NEW_TOKENS, wall_s=wall, init_s=init_s,
        tokens=m["tokens"], tokens_per_s=m["aggregate_tokens_per_s"],
        ttft_p50_ms=m["ttft_p50_ms"], ttft_p99_ms=m["ttft_p99_ms"],
        decode_ms_per_token_p50=m["token_lat_p50_ms"],
        decode_ms_per_token_p99=m["token_lat_p99_ms"],
        eager_tokens_per_s=eager_m["aggregate_tokens_per_s"],
        eager_decode_ms_per_token_p50=eager_m["token_lat_p50_ms"],
        eager_ttft_p50_ms=eager_m["ttft_p50_ms"],
        graphed_equals_eager=dict(greedy=len(graphed),
                                  sampled=len(graphed_sampled)),
        hotpath=hotpath,
        decode_steps=life["decode_steps"],
        prefill_chunks=life["prefill_chunks"],
        first_chunk_logits_max_abs_err=logits_err,
        logits_tolerance=LOGITS_ATOL,
        first_token_margins=[round(mg, 4) for _, mg in plain_first],
        launches=engine_launches)


def paged_requests(vocab: int):
    """The warm-up prompt (the shared prefix and one block of its own) and
    the phase's 9 prompts: 8 of the shared prefix plus a 32-token suffix,
    and one cold prompt of the same length."""
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    shared = [prefix + rng.integers(0, vocab, SUFFIX).tolist()
              for _ in range(N_REQUESTS)]
    cold = rng.integers(0, vocab, SHARED_PREFIX + SUFFIX).tolist()
    warm = prefix + rng.integers(0, vocab, KV_BLOCK_LEN).tolist()
    return warm, shared + [cold]


def new_engine(serving, params, cfg, dev, **kw):
    return serving.ContinuousBatchEngine(
        params, cfg, num_slots=NUM_SLOTS, max_seq=cfg.max_seq,
        prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK, device=dev, **kw)


def transcripts(eng, prompts, temperature=None):
    rids = [eng.submit(p, NEW_TOKENS, temperature=temperature)
            for p in prompts]
    eng.run()
    return [eng.result(r) for r in rids]


@contextlib.contextmanager
def spying(targets):
    """Count calls of module attributes [(module, name), ...] while the
    block runs (the package itself is left unchanged)."""
    counts = {name: 0 for _, name in targets}
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def counted(name, fn):
        def call(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def run_paged_engine(dev, mods, cfg, params) -> dict:
    """The paged engine at the serve defaults with pages of 16: a warm-up
    request publishes the shared prefix, then the 9 requests run with the
    launch counters and the spies on. Then the paged engine is held to the
    dense engine on the same requests: bf16 (count of identical
    transcripts, printed) and f32 (identical transcripts, a hard gate)."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    warm, prompts = paged_requests(cfg.vocab_size)

    def warmed(**kw):
        eng = new_engine(serving, params, cfg, dev,
                         kv_block_len=KV_BLOCK_LEN, **kw)
        w = eng.submit(warm, 4)
        eng.run()
        if eng.result(w).finish_reason != "length":
            fail(f"paged warm-up request: {eng.result(w)}")
        eng.release(w)
        return eng
    eng = warmed(watchdog_timeout=WATCHDOG_S)
    capture_ms = eng._graph.capture_ms
    before = eng.metrics_snapshot()
    peak = {"blocks_used": 0, "blocks_shared": 0}
    kernels.reset_launches()
    with spying([(serving, "_dense_attend"),
                 (paged, "paged_decode_attention_plain"),
                 (torch.nn.functional, "scaled_dot_product_attention")]) \
            as spied:
        t0 = time.perf_counter()
        rids = [eng.submit(p, NEW_TOKENS) for p in prompts]
        while eng.active:
            eng.step()
            kv = eng.metrics_snapshot()["kv_cache"]
            for k in peak:
                peak[k] = max(peak[k], kv[k])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    m = eng.metrics()
    life = {k: m["lifetime"][k] - before["lifetime"][k]
            for k in ("prefill_chunks", "decode_steps")}
    want = expected_launches(cfg.n_layers, life, paged=True)
    if launches != want:
        fail(f"paged engine launches {launches}, its chunks and steps need "
             f"{want}")
    if any(spied.values()):
        fail(f"the paged path reached another decode attention: {spied}")
    for rid in rids:
        r = eng.result(rid)
        if r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS:
            fail(f"paged request {rid} ended {r.finish_reason} with "
                 f"{len(r.tokens)} tokens: {r.error}")
        if not all(0 <= t < cfg.vocab_size for t in r.tokens) \
                or not all(np.isfinite(r.logprobs)):
            fail(f"paged request {rid} has out-of-range tokens or "
                 f"non-finite logprobs")
    kv = m["kv_cache"]
    matched = (kv["matched_tokens_total"]
               - before["kv_cache"]["matched_tokens_total"])
    prompt_tokens = (kv["prompt_tokens_total"]
                     - before["kv_cache"]["prompt_tokens_total"])
    if matched != N_REQUESTS * SHARED_PREFIX:
        fail(f"paged engine matched {matched} prompt tokens, want "
             f"{N_REQUESTS * SHARED_PREFIX}")
    graphed = [eng.result(r) for r in rids]
    paged_bf16 = [r.tokens for r in graphed]
    hotpath = dict(check_graphed(eng, "paged engine"), capture_ms=capture_ms)
    graphed_sampled = transcripts(eng, prompts, SAMPLED_T)
    check_graphed(eng, "paged engine, sampled")
    hotpath.update(greedy_ms_per_token_p50=decode_p50_ms(graphed),
                   sampled_ms_per_token_p50=decode_p50_ms(graphed_sampled))
    del eng
    ref = warmed(cuda_graph=False, overlap_commit=False)
    hold_to_eager(graphed, transcripts(ref, prompts), "paged engine (greedy)")
    eager_m = ref.metrics()
    hold_to_eager(graphed_sampled, transcripts(ref, prompts, SAMPLED_T),
                  "paged engine (sampled)")
    del ref
    dense_bf16 = [r.tokens for r in transcripts(
        new_engine(serving, params, cfg, dev), prompts)]

    # The f32 gate: the same weights cast to f32, full-f32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    dense32 = transcripts(new_engine(serving, p32, cfg32, dev), prompts)
    paged32 = transcripts(new_engine(serving, p32, cfg32, dev,
                                     kv_block_len=KV_BLOCK_LEN), prompts)
    if [r.tokens for r in paged32] != [r.tokens for r in dense32]:
        diverged = [i for i, (a, b) in enumerate(zip(paged32, dense32))
                    if a.tokens != b.tokens]
        fail(f"f32 paged and dense transcripts differ (requests {diverged})")
    lp_err = max(float(np.max(np.abs(np.subtract(a.logprobs, b.logprobs))))
                 for a, b in zip(paged32, dense32))
    del p32, dense32, paged32
    torch.cuda.empty_cache()
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", num_slots=NUM_SLOTS,
                    prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK,
                    kv_block_len=KV_BLOCK_LEN,
                    kv_num_blocks=kv["blocks_total"] + 1),
        requests=len(rids), prompt_lens=[len(p) for p in prompts],
        shared_prefix=SHARED_PREFIX, new_tokens=NEW_TOKENS, wall_s=wall,
        tokens=m["tokens"], tokens_per_s=m["aggregate_tokens_per_s"],
        ttft_p50_ms=m["ttft_p50_ms"], ttft_p99_ms=m["ttft_p99_ms"],
        decode_ms_per_token_p50=m["token_lat_p50_ms"],
        decode_ms_per_token_p99=m["token_lat_p99_ms"],
        eager_tokens_per_s=eager_m["aggregate_tokens_per_s"],
        eager_decode_ms_per_token_p50=eager_m["token_lat_p50_ms"],
        eager_ttft_p50_ms=eager_m["ttft_p50_ms"],
        graphed_equals_eager=dict(greedy=len(graphed),
                                  sampled=len(graphed_sampled)),
        hotpath=hotpath,
        decode_steps=life["decode_steps"],
        prefill_chunks=life["prefill_chunks"],
        kv_cache=dict(peak_blocks_used=peak["blocks_used"],
                      peak_blocks_shared=peak["blocks_shared"],
                      blocks_cached=kv["blocks_cached"],
                      blocks_total=kv["blocks_total"],
                      deferrals=kv["deferrals_total"],
                      evictions=kv["evictions_total"],
                      matched_tokens=matched,
                      hit_rate=matched / prompt_tokens),
        prefix_hits=m["prefix_cache"]["hits"],
        f32_transcripts_identical=True, f32_logprob_max_abs_diff=lp_err,
        bf16_transcripts_identical=sum(a == b for a, b in
                                       zip(paged_bf16, dense_bf16)),
        bf16_requests=len(prompts), spied_calls=spied, launches=launches)


# ---------------------------------------------------------------------------
# Phase 3b: priority admission and preemption on the paged engine
# ---------------------------------------------------------------------------


def tenancy_prompts(vocab: int):
    rng = np.random.default_rng(16)
    return ([rng.integers(0, vocab, TENANCY_BATCH_PROMPT).tolist()
             for _ in range(TENANCY_BATCH)],
            [rng.integers(0, vocab, TENANCY_I_PROMPT).tolist()
             for _ in range(TENANCY_INTERACTIVE)])


def tenancy_kw(temperature, key: int, i: int) -> dict:
    return dict(temperature=temperature, prng_key=[TENANCY_KEY + key, i])


def watch_preemptions(eng) -> dict:
    """Time every preempting eject of `eng` and count the victims' tokens
    that a chunk in flight (or a first token on its way) had produced and
    the eject dropped: they regenerate on the resuming engine."""
    seen = {"eject_ms": [], "dropped": 0}
    eject = eng.eject

    def timed(rid, reason="eject"):
        req = eng.result(rid)
        if reason == "preempt" and not req.done:
            left = req.max_new_tokens - len(req.tokens)
            if any(p.req is req for p in eng._pending_first):
                seen["dropped"] += 1
                left -= 1
            inflight = eng._inflight
            if inflight is not None and any(r is req for _, r in
                                            inflight.snapshot):
                seen["dropped"] += max(0, min(inflight.n, left))
        t0 = time.perf_counter()
        out = eject(rid, reason)
        if reason == "preempt":
            seen["eject_ms"].append((time.perf_counter() - t0) * 1e3)
        return out
    eng.eject = timed                # _preempt_for calls self.eject
    return seen


def tenancy_run(eng, batch, interactive, temperature=None) -> dict:
    """The batch requests, then the interactive ones once every batch
    request has TENANCY_ARRIVE tokens, on `eng` to the end. Returns the
    requests, the wall and the tokens generated on this engine."""
    preempted0 = eng.metrics_snapshot()["migration"]["preempted_total"]
    t0 = time.perf_counter()
    bids = [eng.submit(p, TENANCY_BATCH_NEW, priority="batch",
                       tenant="bulk", **tenancy_kw(temperature, 0, i))
            for i, p in enumerate(batch)]
    for _ in range(100000):
        if all(len(eng.result(r).tokens) >= TENANCY_ARRIVE
               for r in bids):
            break
        eng.step()
    else:
        fail("tenancy: the batch requests never reached "
             f"{TENANCY_ARRIVE} tokens")
    iids = [eng.submit(p, TENANCY_I_NEW, **tenancy_kw(temperature, 1, i))
            for i, p in enumerate(interactive)]
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [eng.result(r) for r in bids + iids]
    tokens = sum(len(r.tokens) - r.emit_from for r in reqs)
    return dict(batch=reqs[:len(bids)], interactive=reqs[len(bids):],
                wall_s=wall, tokens=tokens, preempted0=preempted0)


def resume_state_of(eng, st):
    """A victim's resume state continued on `eng` to its end."""
    rid = eng.submit(st["prompt"], st["maxNewTokens"],
                     committed=st["committed"] or None,
                     prng_key=st["prngKey"], temperature=st["temperature"],
                     tenant=st["tenant"], priority=st["priority"],
                     preempted=st["preempted"])
    eng.run()
    return eng.result(rid)


def divergence(got: list, want: list):
    """The first index where two token lists differ (None: equal)."""
    if got == want:
        return None
    return next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                min(len(got), len(want)))


def check_tenancy_run(eng, run: dict, ref: dict, want_b: list,
                      resume: tuple, what: str) -> dict:
    """`run` (the graphed, pipelined engine) against `ref` (the same
    arrivals on the eager, serialized engine): every request's tokens,
    logprobs and resume state bit for bit. Each victim carries its tenancy
    keys with one hop, its committed tokens are its uninterrupted stream's,
    and its resume on the graphed engine of `resume` equals its resume on
    the eager one bit for bit; the resumed stream is compared with the
    uninterrupted one `want_b` (counted: bf16 re-prefills the committed
    tokens through the prefill kernels, where the uninterrupted stream
    decoded them, so a near-tie may later round the other way). No page
    leaked, one capture, no watchdog trip, preemptions_total up by the
    victims."""
    got_all = run["batch"] + run["interactive"]
    ref_all = ref["batch"] + ref["interactive"]
    for i, (g, w) in enumerate(zip(got_all, ref_all)):
        if (g.tokens, g.logprobs, g.resume_state, g.finish_reason) != \
                (w.tokens, w.logprobs, w.resume_state, w.finish_reason):
            fail(f"{what}: request {i} of the graphed engine differs from "
                 f"the eager engine's")
    victims, resumed, diverged, prefill_tokens = [], 0, [], 0
    for i, r in enumerate(run["batch"]):
        if r.finish_reason != "migrated":
            if r.finish_reason != "length":
                fail(f"{what}: batch request {i} ended {r.finish_reason}")
            continue
        st = r.resume_state
        k = len(st["committed"])
        if (st["reason"], st["priority"], st["tenant"], st["preempted"]) \
                != ("preempt", "batch", "bulk", 1) \
                or st["committed"] != want_b[i].tokens[:k]:
            fail(f"{what}: victim {i} carries {st}")
        victims.append(i)
        g, e = (resume_state_of(x, st) for x in resume)
        if (g.tokens, g.logprobs) != (e.tokens, e.logprobs) \
                or g.preempted != 1:
            fail(f"{what}: victim {i}'s resume on the graphed engine "
                 f"differs from its resume on the eager engine")
        j = divergence(g.tokens, want_b[i].tokens)
        if j is None:
            resumed += 1
        else:
            diverged.append(dict(
                victim=i, committed=k, at=j,
                logprob_resumed=g.logprobs[j],
                logprob_uninterrupted=want_b[i].logprobs[j]))
        prefill_tokens += len(st["prompt"]) + k
    if any(r.finish_reason != "length" for r in run["interactive"]):
        fail(f"{what}: an interactive request did not finish")
    m = eng.metrics()
    preempted = m["migration"]["preempted_total"] - run["preempted0"]
    if preempted != len(victims):
        fail(f"{what}: preempted_total rose by {preempted}, victims "
             f"{len(victims)}")
    kv = m["kv_cache"]
    if kv["blocks_free"] + kv["blocks_cached"] != kv["blocks_total"]:
        fail(f"{what}: pages leaked: {kv}")
    check_graphed(eng, what)
    ttft = sorted((r.first_token_at - r.submitted_at) * 1e3
                  for r in run["interactive"])
    from k8s_gpu_workload_enhancer_tpu_torch.utils.stats import percentile
    return dict(victims=len(victims),
                committed_at_preempt=[len(r.resume_state["committed"])
                                      for r in run["batch"]
                                      if r.resume_state is not None],
                resumes_equal_uninterrupted=resumed,
                resumes_diverged=diverged,
                interactive_ttft_p50_ms=percentile(ttft, 50),
                interactive_ttft_p99_ms=percentile(ttft, 99),
                wall_s=run["wall_s"], tokens=run["tokens"],
                tokens_per_s=run["tokens"] / run["wall_s"],
                resume_prefill_tokens=prefill_tokens)


def run_tenancy(dev, mods, cfg, params) -> dict:
    """Priority admission and preemption on the graphed, pipelined paged
    engine at the serve defaults, with the launch counters set to 0 just
    before it and read after: at preempt_cap 2 the interactive arrivals
    preempt the 4 most recent batch requests (a chunk in flight decoding
    for each), at 0 they wait for slots; greedy, then sampled; then the
    pool-pressure engine. Each run is repeated on an eager, serialized
    engine and held to it bit for bit, victims' resumes included; every
    request also runs uninterrupted on the eager engine. Then, not
    counted, the f32 gate: the cap-2 runs on the weights cast to f32,
    where every victim's resume must equal its uninterrupted stream."""
    kernels, serving = mods[0], mods[7]
    batch, interactive = tenancy_prompts(cfg.vocab_size)
    kernels.reset_launches()
    engines = []

    def paged_engine(p=params, c=cfg, graphed=True, **kw):
        if graphed:
            kw["watchdog_timeout"] = WATCHDOG_S
        else:
            kw.update(cuda_graph=False, overlap_commit=False)
        engines.append(new_engine(serving, p, c, dev,
                                  kv_block_len=KV_BLOCK_LEN, **kw))
        return engines[-1]

    def uninterrupted(eng):
        # The batch requests together, then the interactive ones (a decode
        # step's numbers do not depend on its company: every step decodes
        # all slots).
        return {t: tuple(run_all(eng, [(p, n, tenancy_kw(t, key, i))
                                       for i, p in enumerate(prompts)])
                         for key, prompts, n in (
                             (0, batch, TENANCY_BATCH_NEW),
                             (1, interactive, TENANCY_I_NEW)))
                for t in (None, SAMPLED_T)}
    want = uninterrupted(paged_engine(graphed=False))
    resume = (paged_engine(), paged_engine(graphed=False))
    out = {}
    for cap in (2, 0):
        eng = paged_engine(preempt_cap=cap)
        ref = paged_engine(graphed=False, preempt_cap=cap)
        seen = watch_preemptions(eng)
        for t, name in ((None, "greedy"), (SAMPLED_T, "sampled")):
            before = len(seen["eject_ms"])
            rep = check_tenancy_run(
                eng, tenancy_run(eng, batch, interactive, t),
                tenancy_run(ref, batch, interactive, t), want[t][0], resume,
                f"tenancy cap {cap} {name}")
            if cap and rep["victims"] != TENANCY_INTERACTIVE:
                fail(f"tenancy cap {cap} {name}: {rep['victims']} victims, "
                     f"want {TENANCY_INTERACTIVE}")
            if not cap and rep["victims"]:
                fail(f"tenancy cap 0 {name}: {rep['victims']} preempted")
            rep["eject_ms"] = seen["eject_ms"][before:]
            out[f"cap{cap}_{name}"] = rep
        out[f"cap{cap}_dropped_in_flight"] = seen["dropped"]
        out[f"cap{cap}_hotpath"] = hotpath_report(eng)
    n = TENANCY_POOL_BATCH
    pool = paged_engine(kv_num_blocks=TENANCY_POOL_BLOCKS)
    seen = watch_preemptions(pool)
    rep = check_tenancy_run(
        pool, tenancy_run(pool, batch[:n], interactive),
        tenancy_run(paged_engine(graphed=False,
                                 kv_num_blocks=TENANCY_POOL_BLOCKS),
                    batch[:n], interactive),
        want[None][0][:n], resume, "tenancy pool pressure")
    deferrals = pool.metrics()["kv_cache"]["deferrals_total"]
    if not rep["victims"] or not deferrals:
        fail(f"tenancy pool pressure: {rep['victims']} victims, "
             f"{deferrals} deferrals")
    out["pool_pressure"] = dict(rep, deferrals=deferrals,
                                eject_ms=seen["eject_ms"],
                                dropped_in_flight=seen["dropped"],
                                blocks_total=pool.metrics()["kv_cache"][
                                    "blocks_total"])
    check_graphed(resume[0], "tenancy resume engine")
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    life = {k: sum(e.metrics()["lifetime"][k] for e in engines)
            for k in ("prefill_chunks", "decode_steps")}
    want_launches = expected_launches(cfg.n_layers, life, paged=True)
    if launches != want_launches:
        fail(f"tenancy launches {launches}, its chunks and steps need "
             f"{want_launches}")
    for e in engines:
        e.__dict__.pop("eject", None)     # the timing wrapper's cycle
    del engines[:], resume, pool, eng, ref
    torch.cuda.empty_cache()

    # The f32 gate (not counted): full-f32 products, where the re-prefill
    # of the committed tokens leaves every margin far above the rounding.
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    want32 = uninterrupted(paged_engine(p32, cfg32, graphed=False))
    resume32 = (paged_engine(p32, cfg32), paged_engine(p32, cfg32,
                                                       graphed=False))
    gate32 = {}
    eng = paged_engine(p32, cfg32, preempt_cap=2)
    ref = paged_engine(p32, cfg32, graphed=False, preempt_cap=2)
    for t, name in ((None, "greedy"), (SAMPLED_T, "sampled")):
        rep = check_tenancy_run(
            eng, tenancy_run(eng, batch, interactive, t),
            tenancy_run(ref, batch, interactive, t), want32[t][0], resume32,
            f"tenancy f32 {name}")
        if rep["victims"] != TENANCY_INTERACTIVE or rep["resumes_diverged"]:
            fail(f"tenancy f32 {name}: {rep['victims']} victims, resumes "
                 f"that left the uninterrupted stream: "
                 f"{rep['resumes_diverged']}")
        gate32[name] = dict(victims=rep["victims"],
                            committed_at_preempt=rep[
                                "committed_at_preempt"],
                            resumes_equal_uninterrupted=rep[
                                "resumes_equal_uninterrupted"])
    del engines[:], resume32, eng, ref, p32
    torch.cuda.empty_cache()

    ejects = [ms for k in ("cap2_greedy", "cap2_sampled")
              for ms in out[k]["eject_ms"]] + out["pool_pressure"]["eject_ms"]
    bf16_runs = ("cap2_greedy", "cap2_sampled", "pool_pressure")
    summary = dict(
        interactive_ttft_p50_ms={c: out[f"cap{c}_greedy"][
            "interactive_ttft_p50_ms"] for c in (2, 0)},
        interactive_ttft_p99_ms={c: out[f"cap{c}_greedy"][
            "interactive_ttft_p99_ms"] for c in (2, 0)},
        eject_ms_per_preemption_p50=float(np.median(ejects)),
        eject_ms_per_preemption_max=max(ejects),
        preemptions=len(ejects),
        batch_tokens_dropped_in_flight=(out["cap2_dropped_in_flight"]
                                        + out["pool_pressure"][
                                            "dropped_in_flight"]),
        tokens_per_s={c: out[f"cap{c}_greedy"]["tokens_per_s"]
                      for c in (2, 0)},
        graphed_equals_eager=True,
        bf16_resumes_equal_uninterrupted=[
            sum(out[k]["resumes_equal_uninterrupted"] for k in bf16_runs),
            sum(out[k]["victims"] for k in bf16_runs)],
        bf16_resumes_diverged=[d for k in bf16_runs
                               for d in out[k]["resumes_diverged"]],
        f32_resumes_equal_uninterrupted=True)
    return dict(config=dict(batch=TENANCY_BATCH,
                            batch_prompt=TENANCY_BATCH_PROMPT,
                            batch_new=TENANCY_BATCH_NEW,
                            interactive=TENANCY_INTERACTIVE,
                            interactive_prompt=TENANCY_I_PROMPT,
                            interactive_new=TENANCY_I_NEW,
                            arrive_after=TENANCY_ARRIVE,
                            kv_block_len=KV_BLOCK_LEN,
                            pool_blocks=TENANCY_POOL_BLOCKS),
                summary=summary, runs=out, f32_gate=gate32,
                decode_steps=life["decode_steps"],
                prefill_chunks=life["prefill_chunks"], launches=launches)


def run_all(eng, requests) -> list:
    """[(prompt, new tokens, submit keywords)] submitted at once and run
    to the end; their finished requests."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in requests]
    eng.run()
    return [eng.result(r) for r in rids]


# ---------------------------------------------------------------------------
# Phase 4: the serve main, in-process
# ---------------------------------------------------------------------------


def post(port: int, body: dict, timeout: float = 300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


def refused(port: int, body: dict, headers=None):
    """(status, reply, Retry-After) of a /v1/generate the serve refuses."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), None
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def run_serve(serve, kernels, paged: bool = False) -> dict:
    """The serve main in-process, with the launch counters set to 0 just
    before it starts and read after it exits. Dense: three requests, one
    streamed. Paged (--kv-block-len 16): two requests sharing a 128-token
    prefix, the second served from the first one's pages. Both: a
    "priority": "bogus" request answers 400, and one of a tenant whose
    budget (--tenant-budget probe=0) is spent answers 429 with reason
    "budget-exhausted" and a Retry-After to the end of the day; neither
    reaches the engine."""
    stop = threading.Event()
    ready = {}
    got_port = threading.Event()

    def on_ready(port):
        ready["port"] = port
        got_port.set()

    rc = {}
    argv = ["--device", "cuda", "--port", "0", "--seed", "0",
            "--tenant-budget", "probe=0"]
    if paged:
        argv += ["--kv-block-len", str(KV_BLOCK_LEN)]
    allocated_before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    th = threading.Thread(target=lambda: rc.update(rc=serve.main(
        argv, stop=stop, on_ready=on_ready)), daemon=True)
    t0 = time.perf_counter()
    th.start()
    try:
        if not got_port.wait(600):
            fail("serve main did not come up")
        boot_s = time.perf_counter() - t0
        port = ready["port"]
        rng = np.random.default_rng(1)
        vocab = SERVE_DIMS["vocab_size"]
        if paged:
            prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
            prompts = [prefix + rng.integers(0, vocab, 16).tolist()
                       for _ in range(2)]
        else:
            prompts = [rng.integers(0, vocab, n).tolist()
                       for n in (16, PREFILL_LEN)]
        replies = []
        for prompt in prompts:
            with post(port, {"prompt": prompt, "maxNewTokens": 16,
                             "timeoutSeconds": 300}) as resp:
                r = json.loads(resp.read())
            if r.get("status") != "ok" or len(r["tokens"]) != 16:
                fail(f"/v1/generate reply: {r}")
            replies.append(r)
        ttfts = [r["ttftMs"] for r in replies]
        stream_lines = 0
        if not paged:
            prompt = rng.integers(0, vocab, 40).tolist()
            with post(port, {"prompt": prompt, "maxNewTokens": 24,
                             "stream": True, "timeoutSeconds": 300}) as resp:
                lines = [json.loads(x)
                         for x in resp.read().decode().splitlines()]
            final = lines[-1]
            streamed = [t for x in lines[:-1] for t in x["tokens"]]
            if final.get("status") != "ok" or streamed != final["tokens"] \
                    or len(streamed) != 24:
                fail(f"streamed /v1/generate: {lines}")
            ttfts.append(final["ttftMs"])
            stream_lines = len(lines)
        bogus = refused(port, {"prompt": prompts[0], "maxNewTokens": 4,
                               "priority": "bogus"})
        if bogus[0] != 400 or "priority" not in bogus[1].get("error", ""):
            fail(f'"priority": "bogus" answered {bogus}')
        budget = refused(port, {"prompt": prompts[0], "maxNewTokens": 4},
                         {"x-ktwe-tenant": "probe"})
        if budget[0] != 429 or budget[1].get("reason") != \
                "budget-exhausted" or not budget[2] \
                or not 0 < float(budget[2]) <= 86400:
            fail(f"the spent budget's request answered {budget}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as resp:
            if resp.status != 200:
                fail(f"/health answered {resp.status}")
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/metrics",
                                    timeout=30) as resp:
            metrics = json.loads(resp.read())["metrics"]
    finally:
        stop.set()
        th.join(120)
    if th.is_alive() or rc.get("rc") != 0:
        fail(f"serve main did not drain and exit 0: {rc}")
    # Read without a gc.collect(): what main() leaves on the card.
    retained_gb = (torch.cuda.memory_allocated() - allocated_before) / 1e9
    kv = metrics["kv_cache"]
    if paged and kv["matched_tokens_total"] < SHARED_PREFIX:
        fail(f"paged serve reused no prefix: {kv}")
    tenancy = metrics["tenancy"]
    if tenancy["budget_rejections_total"] != 1 or \
            tenancy["by_priority"]["interactive"]["requests"] != len(ttfts):
        fail(f"serve tenancy block: {tenancy}")
    return dict(boot_s=boot_s, requests=len(ttfts), stream_lines=stream_lines,
                refused=dict(bogus_priority=bogus[0],
                             budget_exhausted=[budget[0],
                                               budget[1].get("reason"),
                                               float(budget[2])]),
                ttft_ms=ttfts, requests_completed=metrics["requests_completed"],
                lifetime=metrics["lifetime"],
                kv_cache={k: kv[k] for k in ("paged", "block_len",
                                             "matched_tokens_total",
                                             "prefix_hit_rate")},
                retained_after_return_gb=retained_gb,
                launches=dict(kernels.launches))


# ---------------------------------------------------------------------------
# Phase 5: training
# ---------------------------------------------------------------------------


def per_step_launches(n_layers: int, stash: bool, flagship: bool = False,
                      microbatches: int = 1, bf16: bool = True,
                      head_dim: int = 128, fused_ce: bool = None) -> dict:
    """Kernel launches of one train step of the dense model: per microbatch
    one embedding gather, 2L+1 norms forward and backward, q and k rotated
    forward and back, L flash forward (in bf16 every one on the
    tensor-core body, in f32 none), dQ and dK/dV calls (the stash dK/dV
    kernel when the p/ds stash fits under its gate, else the recompute
    one; in bf16 dQ and the stash dK/dV on their tensor-core bodies at
    every head_dim, the recompute dK/dV at head_dim <= 128; in f32 none).
    On the flagship's paths the rotations
    are the t-layout pair (2L each way), v and the attention output pass
    the relayout pair (L each way forward, L each way back: 2L each) and
    the loss is one fused CE forward and backward (in bf16 both on their
    tensor-core bodies, in f32 neither; `fused_ce` False for a t-layout
    model without the cached-logits CE, whose loss is plain torch);
    elsewhere 4L RoPE launches."""
    fused_ce = flagship if fused_ce is None else fused_ce
    want = {"embed_gather": 1,
            "rms_norm": 2 * n_layers + 1, "rms_norm_bwd": 2 * n_layers + 1,
            "flash_attention": n_layers, "flash_attention_bwd_dq": n_layers,
            ("flash_attention_bwd_dkv_stash" if stash
             else "flash_attention_bwd_dkv"): n_layers}
    if bf16:
        want["flash_attention_wgmma"] = n_layers
        want["flash_attention_bwd_dq_wgmma"] = n_layers
        if stash:
            want["flash_attention_bwd_dkv_stash_wgmma"] = n_layers
        elif head_dim <= 128:
            want["flash_attention_bwd_dkv_wgmma"] = n_layers
    if flagship:
        want.update(rope_t=2 * n_layers, rope_t_inv=2 * n_layers,
                    relayout_to_t=2 * n_layers, relayout_from_t=2 * n_layers)
    else:
        want["rope"] = 4 * n_layers
    if fused_ce:
        want.update(fused_ce_fwd=1, fused_ce_bwd=1)
        if bf16:
            want.update(fused_ce_fwd_wgmma=1, fused_ce_bwd_wgmma=1)
    return {k: n * microbatches for k, n in want.items()}


def step_launches(snaps: list, launches: dict, want: dict, what: str) -> list:
    """Per-step launch deltas from the counter snapshots taken after each
    step; fails unless every step launched exactly `want` and nothing
    launched outside the steps."""
    prev, per_step = {}, []
    for snap in snaps:
        delta = {k: n - prev.get(k, 0) for k, n in snap.items()
                 if n - prev.get(k, 0)}
        per_step.append(delta)
        prev = snap
        if delta != want:
            fail(f"{what} step launched {delta}, want {want}")
    if not snaps or launches != snaps[-1]:
        fail(f"{what} launched kernels outside its steps: {launches}")
    return per_step


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in leaf_names(v, f"{prefix}/{k}")]
    return [prefix]


def run_train_gate(dev, mods, dims=GATE_DIMS, batch=GATE_BATCH,
                   flagship=False) -> dict:
    """f32 at full width (the trainer's: 2 layers, batch 2, seq 512; the
    flagship's: 1 layer, batch 1, seq 512): the model loss and every
    gradient leaf through the kernels against the same step through the
    plain versions, same weights and batch. The kernel step runs twice:
    with the p/ds stash (it fits under its gate here) and with the gate set
    to 0, so the recompute dK/dV kernel runs too."""
    kernels, rms, rope, flash, tf, trainer = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tf.TransformerConfig(**dims, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = tf.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, cfg.max_seq + 1),
                         generator=gen, device=dev)

    def loss_and_grads():
        p = trainer.tree_map(lambda t: t.detach().clone().requires_grad_(),
                             params)
        loss, _ = tf.loss_fn(p, toks, cfg)
        grads = torch.autograd.grad(loss, trainer.tree_leaves(p))
        return loss.item(), grads

    runs = {}
    limit = flash.PDS_STASH_LIMIT_BYTES
    for path, gate in (("stash", limit), ("recompute", 0)):
        flash.PDS_STASH_LIMIT_BYTES = gate
        try:
            kernels.reset_launches()
            runs[path] = loss_and_grads() + (dict(kernels.launches),)
        finally:
            flash.PDS_STASH_LIMIT_BYTES = limit
    kernels.reset_launches()
    with plain_versions(rms, rope, flash):
        p_loss, p_grads = loss_and_grads()
    if dict(kernels.launches):
        fail("the plain-version reference step launched kernels")
    out = dict(config=dict(dims, batch=batch, dtype="float32"),
               plain_loss=p_loss, loss_rtol=GATE_LOSS_RTOL,
               leaf_rtol=GATE_LEAF_RTOL)
    for path, (k_loss, k_grads, launches) in runs.items():
        want = per_step_launches(cfg.n_layers, stash=path == "stash",
                                 flagship=flagship, bf16=False)
        if any(launches.get(k, 0) for k in WGMMA_COUNTERS.values()):
            fail(f"f32 gate step ({path}) ran a bf16 tensor-core flash "
                 f"body: {launches}")
        if launches != want:
            fail(f"f32 gate step ({path}) launched {launches}, want {want}")
        loss_rel = abs(k_loss - p_loss) / abs(p_loss)
        leaf_err = {}
        for name, a, b in zip(leaf_names(params), k_grads, p_grads):
            leaf_err[name] = float((a - b).norm() / b.norm().clamp_min(1e-30))
            if not torch.isfinite(a).all():
                fail(f"f32 gate ({path}): gradient {name} has non-finite "
                     f"values")
        worst = max(leaf_err, key=leaf_err.get)
        if not loss_rel <= GATE_LOSS_RTOL or leaf_err[worst] >= GATE_LEAF_RTOL:
            fail(f"f32 gate ({path}): loss {k_loss} vs plain {p_loss} (rel "
                 f"{loss_rel}), worst leaf {worst} rel norm error "
                 f"{leaf_err[worst]}")
        out[path] = dict(loss=k_loss, loss_rel_err=loss_rel,
                         leaf_rel_norm_err=leaf_err, worst_leaf=worst,
                         launches=launches)
    del params, runs, p_grads
    torch.cuda.empty_cache()
    return out


def run_trainer(trainer_cli, kernels, batch: int, steps: int,
                stash: bool, experts: int = 0, env=None,
                group_of_one: bool = False) -> dict:
    """The port's trainer main in-process at its defaults (bf16 on the
    card; `experts` > 0 adds --n-experts), with the launch counters set to
    0 just before it starts and read after every step and when it
    returns; `env` is the gang env it bootstraps from (none: one device)
    and `group_of_one` the main's.
    An MoE model launches what the dense one does: its router, dispatch
    and expert products are plain torch."""
    freed_gb = collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    snaps, losses, gnorms, auxes = [], [], [], []

    group = {}

    def on_step(i, metrics):
        snaps.append(dict(kernels.launches))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        auxes.append(float(metrics["aux"]))
        if torch.distributed.is_initialized():
            group.update(backend=torch.distributed.get_backend(),
                         world=torch.distributed.get_world_size())
    argv = ["--device", "cuda", "--steps", str(steps), "--batch-size",
            str(batch), "--seed", "0"]
    if experts:
        argv += ["--n-experts", str(experts)]
    buf = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = trainer_cli.main(argv, callback=on_step, env=env or {},
                              group_of_one=group_of_one)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"trainer main {argv} exited {rc}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines()
             if x.startswith("{")]
    final = lines[-1] if lines else {}
    if not final.get("final") or final.get("steps") != steps - 1:
        fail(f"trainer main printed no final line for {steps} steps: "
             f"{buf.getvalue()[-2000:]}")
    want = per_step_launches(TRAIN_DIMS["n_layers"], stash, head_dim=TRAIN_DIMS[
        "d_model"] // TRAIN_DIMS["n_heads"])
    per_step = step_launches(snaps, launches, want,
                             f"trainer (batch {batch})")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"trainer losses {losses} or grad norms {gnorms} not finite")
    if experts and (final.get("aux") != auxes[-1]
                    or not all(np.isfinite(auxes)) or min(auxes) <= 0):
        fail(f"MoE trainer aux {auxes}, final line {final.get('aux')}")
    moe = dict(n_experts=experts) if experts else {}
    return dict(config=dict(TRAIN_DIMS, batch=batch, dtype="bfloat16",
                            **moe), **(dict(aux=auxes) if experts else {}),
                argv=argv, steps=steps, wall_s=wall,
                step_ms=final["avg_step_s"] * 1e3,
                tokens_per_s=final["tokens_per_s"],
                achieved_tflops=final["achieved_tflops"],
                mfu_pct=final["mfu_pct"], mfu_peak_tflops=989.0,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, freed_by_gc_collect_gb=freed_gb,
                losses=losses, grad_norms=gnorms, process_group=group,
                launches_per_step=per_step[0], launches=launches)


def shard_bytes(tf, dims: dict, world: int) -> dict:
    """Bytes a rank holds of the f32 params and each Adam moment under the
    FSDP rules (every leaf with an embed axis split over `world` ranks,
    the norm scales whole), from the leaf shapes."""
    cfg = tf.TransformerConfig(**dims)

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]
    total = 0
    for shape, axes in zip(leaves(tf.param_shapes(cfg)),
                           leaves(tf.param_logical_axes(cfg))):
        n = int(np.prod(shape))
        total += n // world if "embed" in axes else n
    return {"params": 4 * total, "mu": 4 * total, "nu": 4 * total}


def run_fsdp(trainer_cli, kernels, tf, single: dict, card: str) -> dict:
    """The trainer main at its defaults as a gang of one rank through the
    bootstrap (NUM_PROCESSES=1, KTWE_STRATEGY=FSDP, a localhost
    COORDINATOR_ADDRESS, and `group_of_one`, without which one process
    trains on the single-device path): an NCCL process group of one, the
    DeviceMesh and the FSDP step (each layer's leaves all-gathered before
    use, their gradients reduce-scattered). It must launch per step
    exactly what the single-device train phase launches; its losses must
    equal that phase's (same seed, batch and steps) exactly and its grad
    norms within FSDP_GNORM_RTOL."""
    env = {"COORDINATOR_ADDRESS": f"localhost:{free_port()}",
           "NUM_PROCESSES": "1", "PROCESS_ID": "0", "KTWE_STRATEGY": "FSDP"}
    out = run_trainer(trainer_cli, kernels, TRAIN_BATCH, TRAIN_STEPS,
                      stash=False, env=env, group_of_one=True)
    if out["process_group"] != {"backend": "nccl", "world": 1}:
        fail(f"fsdp phase ran without an NCCL group of one: "
             f"{out['process_group']}")
    if torch.distributed.is_initialized():
        fail("the trainer main left its process group open")
    if out["launches_per_step"] != single["launches_per_step"]:
        fail(f"fsdp step launched {out['launches_per_step']}, the "
             f"single-device step {single['launches_per_step']}")
    rel = {}
    for key, rtol in (("losses", 0.0), ("grad_norms", FSDP_GNORM_RTOL)):
        rel[key] = [abs(a - b) / abs(b)
                    for a, b in zip(out[key], single[key])]
        if len(out[key]) != len(single[key]) or max(rel[key]) > rtol:
            fail(f"fsdp {key} {out[key]} vs single-device {single[key]} "
                 f"(rtol {rtol})")
    dims = {k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"}
    return dict(card=card, world=1, mesh="dp=1", config=out["config"],
                steps=out["steps"], step_ms=out["step_ms"],
                single_device_step_ms=single["step_ms"],
                tokens_per_s=out["tokens_per_s"], mfu_pct=out["mfu_pct"],
                max_memory_allocated_gb=out["max_memory_allocated_gb"],
                single_device_max_memory_allocated_gb=single[
                    "max_memory_allocated_gb"],
                shard_bytes=shard_bytes(tf, dict(
                    dims, n_kv_heads=dims["n_heads"],
                    max_seq=TRAIN_DIMS["seq_len"]), 1),
                losses=out["losses"], grad_norms=out["grad_norms"],
                single_device_losses=single["losses"],
                single_device_grad_norms=single["grad_norms"],
                rel_err=rel, rtol={"losses": 0.0,
                                   "grad_norms": FSDP_GNORM_RTOL},
                launches_per_step=out["launches_per_step"],
                launches=out["launches"], process_group=out["process_group"])


# The tenant_drain phase: two f32 tenants and an undrained reference at the
# trainer's default widths and depth (0.67 B parameters: 8.05 GB of f32
# params and AdamW moments a tenant, what a drain writes and a resume
# reads), trained, drained to checkpoints and resumed. Cut: batch 8 -> 2
# (a drain's time depends on the state, not the batch; at batch 2 the f32
# p/ds stash, 1.07 GB, stays under its 1.2 GB gate and 15 f32 steps stay
# short).
DRAIN_DIMS = dict({k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"},
                  n_kv_heads=TRAIN_DIMS["n_heads"],
                  max_seq=TRAIN_DIMS["seq_len"])
DRAIN_BATCH, DRAIN_BEFORE, DRAIN_AFTER = 2, 3, 2
DRAIN_RTOL = 1e-6


class MeshOracle:
    """The mesh phase's drafter: a request's known greedy continuation, its
    last draft of two or more made wrong (a round accepts and rejects)."""

    def __init__(self, pairs, vocab: int):
        self.pairs, self.vocab = pairs, vocab

    def __call__(self, context, k: int):
        ctx = list(context)
        for prompt, want in self.pairs:
            n = len(ctx) - len(prompt)
            if n >= 0 and ctx[:len(prompt)] == prompt and \
                    ctx[len(prompt):] == want[:n]:
                out = list(want[n:n + k])
                if len(out) >= 2:
                    out[-1] = (out[-1] + 1) % self.vocab
                return out
        return []


def thread_gang(ServingMesh, dp: int, tp: int, rank_fn) -> list:
    """rank_fn(mesh) on every rank of a gang of dp * tp threads on the
    card; the ranks' results in rank order. A failing rank aborts the
    gang's barriers, and the phase fails."""
    meshes, groups = ServingMesh.thread_gang(dp, tp)
    out, errors = [None] * (dp * tp), []

    def one(r):
        try:
            out[r] = rank_fn(meshes[r])
        except BaseException as e:              # noqa: BLE001 — reported
            errors.append(f"rank {r}: {e!r}")
            for g in groups:
                g.abort()
    threads = [threading.Thread(target=one, args=(r,), daemon=True)
               for r in range(dp * tp)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"mesh ({dp}, {tp}) thread gang: {errors or 'hung'}")
    return out


def mesh_engine_run(ServingMesh, serving, decode, dp, tp, full, cfg, dev,
                    drive, **kw) -> dict:
    """An engine on every rank of a (dp, tp) thread gang, each on its
    blocks of `full`; rank 0 runs drive(engine) and stops the followers.
    Adds the driver's broadcasts (headers, their pickled bytes and host
    ms, counted around the engine's send), the wall and the launches."""
    def rank(mesh):
        eng = new_engine(serving, decode.shard_params_for_serving(
            full, cfg, mesh), cfg, dev, mesh=mesh, **kw)
        if not mesh.is_driver:
            eng.follow()
            return None
        sent = {"headers": 0, "bytes": 0, "s": 0.0}
        send = eng._send

        def counted(header):
            t0 = time.perf_counter()
            send(header)
            sent["s"] += time.perf_counter() - t0
            sent["headers"] += 1
            sent["bytes"] += len(pickle.dumps(header))
        eng._send = counted
        programs = record_programs(eng)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = drive(eng)
            torch.cuda.synchronize()
            out["wall_s"] = time.perf_counter() - t0
            out["programs"] = programs
            out["decode_steps"] = eng.metrics()["lifetime"]["decode_steps"]
            n = max(1, sent["headers"])
            out["broadcast"] = {
                "headers": sent["headers"],
                "bytes_per_header": sent["bytes"] / n,
                "ms_per_header": 1e3 * sent["s"] / n,
                "headers_per_decode_step": sent["headers"]
                / max(1, out["decode_steps"])}
            return out
        finally:
            try:
                eng.stop_followers()
            finally:
                # The wrappers' cycles would keep eng.
                del eng._send, eng._prog
    return thread_gang(ServingMesh, dp, tp, rank)[0]


def record_programs(eng) -> list:
    """[program, steps (a decode chunk's; else None), calls] for every
    device program the driver `eng` runs from now on: the collectives of
    its header and of the program on the driver's thread
    (parallel/comm_gate.record)."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    seen, prog = [], eng._prog

    def recorded(name, *args):
        with comm_gate.record(this_thread=True) as calls:
            out = prog(name, *args)
        seen.append((name, args[0] if name == "chunk" else None, calls))
        return out
    eng._prog = recorded
    return seen


def chunk_gate(run: dict, name: str, rows: int, cfg, tp: int,
               gates: list) -> dict:
    """The collective-budget gate on every full decode chunk of a gang's
    driver: the pinned counts of `name` at the model's layers and
    DECODE_CHUNK steps, and every call within the activation-row caps of
    `rows` token rows (parallel/comm_gate.py)."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    want = comm_gate.expected(name, cfg.n_layers, DECODE_CHUNK)
    caps = comm_gate.row_caps(rows, cfg.d_model, cfg.vocab_size, tp)
    chunks = [c for p, n, c in run["programs"]
              if p == "chunk" and n == DECODE_CHUNK]
    largest: dict = {}
    for calls in chunks:
        for op, n in calls:
            largest[op] = max(largest.get(op, 0), n)
        try:
            comm_gate.assert_collective_budget(calls, want, name)
            comm_gate.assert_sizes_within(calls, caps, name)
        except AssertionError as e:
            gates.append(f"collective gate: {e}")
            break
    if not chunks:
        gates.append(f"collective gate: no decode chunk of {name} ran")
    return dict(chunks=len(chunks), counts=comm_gate.collective_counts(
        chunks[0]) if chunks else {}, expected=want, largest_bytes=largest,
        caps=caps)


def mesh_tier_rank(mesh, serving, decode, full, cfg, dev, traffic, tier,
                   marks):
    """A rank of the host tier's run on a mesh: the tier engine (or, with
    `tier` False, the same pool without a tier) on the rank's blocks. Every
    rank logs its shard of each page it demotes and of each page it
    restores (each just as its program runs); the driver runs the kvhost
    waves, logging each demotion's and restore's digest, host seconds and
    collectives (parallel/comm_gate.record)."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    eng = kvhost_engine(serving, decode.shard_params_for_serving(
        full, cfg, mesh), cfg, dev, tier=tier, kv_num_blocks=KVHOST_BLOCKS,
        mesh=mesh)
    events = []
    if tier:
        demote, restore = eng._p_kv_demote, eng._p_kv_restore

        def logged_demote(blk):
            events.append(("demote", [t[:, blk].clone()
                                      for t in eng._cache.leaves()]))
            return demote(blk)

        def logged_restore(blk):
            restore(blk)
            events.append(("restore", [t[:, blk].clone()
                                       for t in eng._cache.leaves()]))
        eng._p_kv_demote, eng._p_kv_restore = logged_demote, logged_restore
    if not mesh.is_driver:
        eng.follow()
        return events
    try:
        if tier:
            t = eng._host_tier
            offload, restore_ = t.offload, t.restore

            def timed(kind, fn, digest, *args):
                n = len(events)
                with comm_gate.record(this_thread=True) as calls:
                    t0 = time.perf_counter()
                    out = fn(*args)
                    torch.cuda.synchronize()
                    s = time.perf_counter() - t0
                if len(events) > n:
                    marks.append((kind, digest, s, calls))
                return out
            t.offload = lambda cache, blk, digest, *a: timed(
                "demote", offload, digest, cache, blk, digest, *a)
            t.restore = lambda cache, blk, entry: timed(
                "restore", restore_, entry.digest, cache, blk, entry)
        got = kvhost_waves(eng, traffic)
        torch.cuda.synchronize()
        m = eng.metrics()
        return dict(events=events, tokens=[r.tokens for r in got["reqs"]],
                    hits=got["hits"], kvhost=m["kvhost"],
                    captures=m["hotpath"]["graphs_captured"],
                    mesh_sig=eng._host_tier.mesh_sig if tier else None)
    finally:
        eng.stop_followers()


def tier_shards_held(ranks: list, marks: list) -> int:
    """Every rank's shard of each restored page equals, bit for bit, its
    shard of that page at its latest demotion: the ranks' events and the
    driver's digests walk in the driver's order. Returns the restores
    held (every rank), or -1 where one differs."""
    digests = [d for _, d, _, _ in marks]
    held = 0
    for events in ranks:
        if len(events) != len(digests):
            return -1
        last = {}
        for (kind, pages), digest in zip(events, digests):
            if kind == "demote":
                last[digest] = pages
            elif digest in last:
                if not all(torch.equal(a, b)
                           for a, b in zip(pages, last[digest])):
                    return -1
                held += 1
    return held


def run_mesh_tier(dev, mods, ServingMesh, bootstrap, p32, cfg32,
                  gates: list) -> dict:
    """The host KV tier on a (1, 4) thread gang and on the (1, 1) mesh over
    an NCCL group of one, f32 at the serve widths (the module note)."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    traffic = kvhost_traffic(cfg32.vocab_size)
    hd = cfg32.d_model // cfg32.n_heads
    out = {}
    for name, shape in (("tp4", (1, 4)), ("one", (1, 1))):
        runs = {}
        for tier in (True, False):
            marks = []

            def rank(mesh):
                return mesh_tier_rank(mesh, serving, decode, p32, cfg32,
                                      dev, traffic, tier, marks)
            if shape == (1, 1):
                ctx, mesh = bootstrap.initialize_serving(
                    shape, {"COORDINATOR_ADDRESS":
                            f"localhost:{free_port()}",
                            "NUM_PROCESSES": "1", "PROCESS_ID": "0"},
                    device="cuda", group_of_one=True)
                try:
                    ranks = [rank(mesh)]
                finally:
                    ctx.close()
            else:
                ranks = thread_gang(ServingMesh, *shape, rank)
            driver = ranks[0]
            runs[tier] = dict(driver=driver, marks=marks,
                              events=[driver["events"]] + ranks[1:])
        on, off = runs[True], runs[False]
        d = on["driver"]
        kv = d["kvhost"]
        what = f"mesh tier {shape}"
        if min(kv["offloads_total"], kv["prefetches_total"],
               kv["hits_total"]) <= 0:
            gates.append(f"{what}: tier counters {kv}")
        if d["tokens"] != off["driver"]["tokens"]:
            gates.append(f"{what}: tokens differ from the tier-off engine's")
        held = tier_shards_held(on["events"], on["marks"])
        if held <= 0:
            gates.append(f"{what}: restored shards held {held}")
        if shape == (1, 1) and d["captures"] != 1:
            gates.append(f"{what}: {d['captures']} graph captures")
        tp = shape[1]
        progs = {}
        for kind in ("demote", "restore"):
            pin = f"serve/kv_{kind}"
            page = comm_gate.tier_calls(pin, cfg32.n_layers, KV_BLOCK_LEN,
                                        cfg32.n_kv_heads, hd, 4, tp)
            calls = [c for k, _, _, c in on["marks"] if k == kind]
            ms = [s * 1e3 for k, _, s, _ in on["marks"] if k == kind]
            headers = [n for c in calls for op, n in c
                       if op == "object-broadcast"]
            for c in calls:
                try:
                    if tp > 1:
                        comm_gate.assert_collective_budget(
                            c, comm_gate.expected(pin), pin)
                    if sorted(x for x in c if x[0] != "object-broadcast") \
                            != (page if tp > 1 else []):
                        raise AssertionError(f"{pin}: page calls {c}, "
                                             f"pinned {page}")
                except AssertionError as e:
                    gates.append(f"{what}: {e}")
                    break
            progs[kind] = dict(
                calls=len(calls), ms_p50=float(np.median(ms)) if ms else 0.0,
                ms_mean=float(np.mean(ms)) if ms else 0.0,
                header_bytes=float(np.mean(headers)) if headers else 0.0,
                page_calls=page if tp > 1 else [])
        out[name] = dict(mesh=list(shape), mesh_sig=d["mesh_sig"],
                         requests=len(d["tokens"]), restores_held=held,
                         equal_tier_off=d["tokens"] == off["driver"]["tokens"],
                         captures=d["captures"], kvhost={
                             k: kv[k] for k in ("offloads_total",
                                                "prefetches_total",
                                                "hits_total",
                                                "discards_total")},
                         **progs)
        del runs, on, off, d
        collect_garbage()
    return out


def run_icibench(gates: list) -> dict:
    """The collective bench's single-rank case over an NCCL group of one
    (cmd/icibench.py, its line as it prints it)."""
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import icibench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = icibench.main(["--mb", str(ICIBENCH_MB)])
    lines = buf.getvalue().strip().splitlines()
    line = json.loads(lines[-1]) if lines else {}
    keys = ["devices", "axis_size", "payload_mb_per_chip", "allreduce_ms",
            "allreduce_gbps_per_chip", "allgather_ms",
            "allgather_gbps_per_chip", "ppermute_ms",
            "ppermute_gbps_per_chip"]
    if code != 0 or list(line) != keys or line["devices"] != 1 or any(
            line[k] <= 0 for k in keys if k.endswith("_ms")):
        gates.append(f"icibench: exit {code}, line {line}")
    if torch.distributed.is_initialized():
        gates.append("icibench: the group was left open")
    return line


def on_thread_group(group, n: int, fn, what: str) -> list:
    """fn(rank) on every rank of a gang of n threads on the card; the
    ranks' results in rank order. A failing rank aborts `group`'s
    barriers, and the phase fails."""
    out, errors = [None] * n, []

    def one(r):
        try:
            out[r] = fn(r)
        except BaseException as e:              # noqa: BLE001 — reported
            errors.append(f"rank {r}: {e!r}")
            group.abort()
    threads = [threading.Thread(target=one, args=(r,), daemon=True)
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"{what} thread gang: {errors or 'hung'}")
    return out


def ep_blocks(tf, embed, attn_mod, params, cfg, toks, layout):
    """The embedding of `toks` and the model's blocks (`_layer`, the MoE
    FFN under `layout`, each rank on its experts): (x, the summed aux)."""
    x = embed.embed_tokens(params["embed"], toks, cfg.d_model, cfg.dtype)
    freqs = attn_mod.rope_frequencies(cfg.head_dim, cfg.max_seq,
                                      cfg.rope_theta, x.device)
    aux = 0.0
    for layer in range(cfg.n_layers):
        lp = tf.layer_params(params, layer)
        if layout is not None:
            lp = layout.expert_block(lp)
        x, a = tf._layer(x, lp, cfg, freqs, 0, layout)
        aux = aux + a
    return x, aux


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-30))


def run_ep(dev, tf, embed, attn_mod, flash, kernels, card: str) -> dict:
    """The ep phase (see EP_RANKS): the blocks forward and backward on the
    virtual ep gang (the ranks' forwards in their threads, one backward
    over the sum of their losses, sum(x * dy) + aux / EP_RANKS a rank)
    against the single-device dense route on the same weights, rows and
    dy (sum(x * dy) + aux): in f32 the output, aux, loss and every
    gradient leaf, router and experts included, within GATE_LOSS_RTOL and
    GATE_LEAF_RTOL; in bf16 the errors recorded. The launches of the table
    kernels the blocks run, per rank, and the all-to-alls: each rank the
    pinned count (parallel/comm_gate.py `train/dp2_ep2/moe`, 4 a MoE layer),
    each call E * N_local * D values of the activation dtype. Host ms of
    the gang's forward and backward and of the single device's (timed warm,
    after the gang), and the gang's peak GB above what the phase holds
    before it."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (
        ExpertLayout)
    collect_garbage()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dims = dict({k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"},
                n_layers=EP_LAYERS, n_kv_heads=TRAIN_DIMS["n_heads"],
                max_seq=TRAIN_DIMS["seq_len"], n_experts=MOE_EXPERTS,
                moe_ragged_dispatch=False)
    seq, rows = TRAIN_DIMS["seq_len"], EP_BATCH // EP_RANKS
    gates, out = [], dict(card=card, config=dict(
        dims, ranks=EP_RANKS, batch=EP_BATCH, rows_a_rank=rows))
    pin = comm_gate.BUDGETS["train/dp2_ep2/moe"]["all-to-all"]
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        cfg = tf.TransformerConfig(**dims, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(EP_SEED)
        params = tf.init_params(gen, cfg)
        params = {k: params[k] for k in ("embed", "layers")}
        leaves = [params["embed"]] + list(params["layers"].values())
        names = ["/embed"] + [f"/layers/{k}" for k in params["layers"]]
        for t in leaves:
            t.requires_grad_(True)
        toks = torch.randint(0, cfg.vocab_size, (EP_BATCH, seq),
                             generator=gen, device=dev)
        dy = (torch.randn(EP_BATCH, seq, cfg.d_model, generator=gen,
                          device=dev) * 1e-2).to(dtype)

        def loss_of(x, aux, part, weight):
            return (x.float() * dy[part].float()).sum() + aux * weight

        def single():
            """The single device, dense route: x, aux, loss, gradients."""
            x, aux = ep_blocks(tf, embed, attn_mod, params, cfg, toks, None)
            loss = loss_of(x, aux, slice(None), 1.0)
            grads = torch.autograd.grad(loss, leaves)
            return (x.detach(), float(aux.detach()), float(loss.detach()),
                    grads)
        # The reference (its first pass also warms the kernels and cuBLAS;
        # it is timed again after the gang).
        x_ref, aux_ref, loss_ref, g_ref = single()
        # The gang.
        group = ThreadGroup(EP_RANKS)
        kernels.reset_launches()
        # Every counter exists before the threads start: an increment is
        # then one dict store under the GIL.
        kernels.launches.update({k: 0 for k in (
            "embed_gather", "rms_norm", "rope", "flash_attention",
            "flash_attention_wgmma")})
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()

        def rank(r):
            return ep_blocks(tf, embed, attn_mod, params, cfg,
                             toks[r * rows:(r + 1) * rows],
                             ExpertLayout(group.comm(r)))
        with comm_gate.record() as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ranks = on_thread_group(group, EP_RANKS, rank, "ep")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = sum(loss_of(x, a, slice(r * rows, (r + 1) * rows),
                               1.0 / EP_RANKS)
                       for r, (x, a) in enumerate(ranks))
            grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        launches = {k: v for k, v in kernels.launches.items() if v}
        x = torch.cat([x.detach() for x, _ in ranks])
        auxes = [float(a.detach()) for _, a in ranks]
        errs = dict(out=rel_err(x, x_ref),
                    aux=abs(auxes[0] - aux_ref) / abs(aux_ref),
                    loss=abs(float(loss.detach()) - loss_ref) / abs(loss_ref),
                    leaves={n: rel_err(g, w) for n, g, w in
                            zip(names, grads, g_ref)})
        worst = max(errs["leaves"], key=errs["leaves"].get)
        if any(not torch.isfinite(g).all() for g in grads):
            gates.append(f"ep {dt}: a gradient has non-finite values")
        if len(set(auxes)) != 1:
            gates.append(f"ep {dt}: the ranks' aux differ: {auxes}")
        if dtype == torch.float32 and not (
                errs["aux"] <= GATE_LOSS_RTOL
                and errs["loss"] <= GATE_LOSS_RTOL
                and errs["out"] < GATE_LEAF_RTOL
                and errs["leaves"][worst] < GATE_LEAF_RTOL):
            gates.append(f"ep f32 against one device: {errs}")
        # Launches: each rank a microbatch's embedding and blocks (no
        # final norm, no loss kernel), the p/ds stash at its rows.
        q = torch.empty(rows, seq, cfg.n_heads, cfg.head_dim, dtype=dtype,
                        device="meta")
        stash = flash.stash_bytes(q, q, q) <= flash.PDS_STASH_LIMIT_BYTES
        want = per_step_launches(EP_LAYERS, stash=stash,
                                 bf16=dtype == torch.bfloat16)
        want.update(rms_norm=2 * EP_LAYERS, rms_norm_bwd=2 * EP_LAYERS)
        want = {k: n * EP_RANKS for k, n in want.items()}
        if launches != want:
            gates.append(f"ep {dt}: launches {launches}, want {want}")
        a2a = [n for op, n in calls if op == "all-to-all"]
        cap = MOE_EXPERTS * rows * seq * cfg.d_model * dtype.itemsize
        want_a2a = EP_RANKS * pin.count(EP_LAYERS)
        if len(a2a) != want_a2a or any(n != cap for n in a2a):
            gates.append(f"ep {dt}: {len(a2a)} all-to-alls of "
                         f"{sorted(set(a2a))} B, want {want_a2a} of {cap}")
        out[dt] = dict(
            errors=errs, worst_leaf=worst, gated=dtype == torch.float32,
            loss_rtol=GATE_LOSS_RTOL, leaf_rtol=GATE_LEAF_RTOL,
            stash=stash, launches=launches, launches_per_rank={
                k: v // EP_RANKS for k, v in launches.items()},
            all_to_all=dict(per_rank=len(a2a) // EP_RANKS,
                            per_rank_per_layer=len(a2a) // EP_RANKS
                            // EP_LAYERS, bytes_each=cap,
                            bytes_per_layer_per_rank=4 * cap),
            collectives=comm_gate.collective_counts(calls),
            host_ms=dict(forward=1e3 * (t1 - t0), backward=1e3 * (t2 - t1),
                         forward_backward=1e3 * (t2 - t0)),
            peak_gb=peak_gb)
        del ranks, loss
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single()
        torch.cuda.synchronize()
        out[dt]["host_ms"]["single_device_forward_backward"] = \
            1e3 * (time.perf_counter() - t0)
        del params, leaves, grads, g_ref, x, x_ref, dy, toks
        collect_garbage()
    out["launches"] = out["bfloat16"]["launches"]
    out["gates_failed"] = gates
    return out


class RankLaunches(collections.Counter):
    """`kernels.launches` while a gang of threads runs: each `+=` of a
    wrapper applied to the current total under a lock (so no increment of
    another thread is lost) and also to the calling thread's own tally
    (`by_thread`); the backward's launches land on the thread that runs
    the backward."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._read = {}
        self.by_thread = collections.defaultdict(collections.Counter)

    def __getitem__(self, k):
        v = super().__getitem__(k)
        self._read[(threading.get_ident(), k)] = v
        return v

    def __setitem__(self, k, v):
        me = threading.get_ident()
        d = v - self._read.pop((me, k), dict.get(self, k, 0))
        with self._lock:
            dict.__setitem__(self, k, dict.get(self, k, 0) + d)
            self.by_thread[me][k] += d


@contextlib.contextmanager
def rank_launches(kernels):
    """`kernels.launches` replaced by a fresh RankLaunches for the block."""
    saved, kernels.launches = kernels.launches, RankLaunches()
    try:
        yield kernels.launches
    finally:
        kernels.launches = saved


def pp_stage_launches(stage: int, stages: int, layers: int, micro: int,
                      stash: bool, bf16: bool, gpipe: bool,
                      embed: bool = True) -> tuple:
    """(forward, backward) launches of one rank of a pp gang: stage 0's
    embedding (none where `embed` is False: the vocab-parallel lookup of
    a tp gang); per layer it runs and microbatch two norms, q and k
    rotated, one flash forward; the backward the same layers' norms,
    rotations, dQ and dK/dV (the stash kernel where it fits its gate); the
    GPipe path's final norm on every stage. In the layer-stack form (not
    `gpipe`) every rank runs every layer on its rows, one microbatch."""
    n = layers * micro
    fwd = {"rms_norm": 2 * n + int(gpipe), "rope": 2 * n,
           "flash_attention": n}
    if embed and (stage == 0 or not gpipe):
        fwd["embed_gather"] = 1
    bwd = {"rms_norm_bwd": 2 * n + int(gpipe), "rope": 2 * n,
           "flash_attention_bwd_dq": n,
           ("flash_attention_bwd_dkv_stash" if stash
            else "flash_attention_bwd_dkv"): n}
    if bf16:
        fwd["flash_attention_wgmma"] = n
        bwd["flash_attention_bwd_dq_wgmma"] = n
        bwd["flash_attention_bwd_dkv_stash_wgmma" if stash
            else "flash_attention_bwd_dkv_wgmma"] = n
    return fwd, bwd


def sum_counts(counts) -> dict:
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


def pp_gang(kernels, comm_gate, group, n: int, fn, what: str) -> dict:
    """fn(rank) -> the rank's loss on a gang of n threads, the forwards'
    launches and collectives by rank, then one backward over the sum of
    the losses from this thread: the losses, forward launches by rank,
    backward launches (the rest), forward calls by rank, backward calls,
    host ms of the forward and of the backward."""
    idents, calls = [None] * n, [None] * n

    def rank(r):
        idents[r] = threading.get_ident()
        with comm_gate.record(this_thread=True) as c:
            calls[r] = c
            return fn(r)
    with rank_launches(kernels) as launches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = on_thread_group(group, n, rank, what)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = [dict(launches.by_thread[i]) for i in idents]
        with comm_gate.record() as back:
            torch.autograd.backward(sum(losses))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        total = {k: v for k, v in launches.items() if v}
    fwd_total = sum_counts(fwd)
    bwd = {k: v - fwd_total.get(k, 0) for k, v in total.items()
           if v - fwd_total.get(k, 0)}
    return dict(losses=losses, fwd=fwd, bwd=bwd, total=total, calls=calls,
                back=list(back), forward_ms=1e3 * (t1 - t0),
                backward_ms=1e3 * (t2 - t1))


def grad_errors(names, grads, want) -> dict:
    return {n: rel_err(g, w) for n, g, w in zip(names, grads, want)}


class Groups:
    """Several ThreadGroups aborted as one (`on_thread_group`'s group)."""

    def __init__(self, groups):
        self.groups = groups

    def abort(self) -> None:
        for g in self.groups:
            g.abort()


def run_pp_tp(dev, tf, pipeline, flash, kernels, comm_gate, base_dims,
              dtype) -> dict:
    """The pp phase's (c) (see PP_TP_STAGES) at `dtype`: `gpipe_lm_loss`
    on a (PP_TP_STAGES, PP_TP) gang of threads, rank r at stage r // PP_TP
    and tp coordinate r % PP_TP, each with its stage's tp blocks, one
    backward over the sum of the ranks' losses, against one device's
    `tf.loss_fn` on the same weights and rows: the errors, the launches
    (forward by rank, backward), the gang's collectives against the pin
    `train/gpipe/pp2_tp2/threads`, host ms and peak GB. Gate failures are
    returned under "gates"."""
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (
        StageLayout)
    dt = str(dtype).split(".")[-1]
    bf16 = dtype == torch.bfloat16
    seq, n = base_dims["max_seq"], PP_TP_STAGES * PP_TP
    rows = TRAIN_BATCH // PP_MICRO
    gates = []
    cfg = tf.TransformerConfig(**dict(base_dims, n_layers=PP_TP_LAYERS),
                               dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(PP_SEED + 2)
    params = tf.init_params(gen, cfg)
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, seq + 1),
                         generator=gen, device=dev)
    names = leaf_names(params)
    leaves = [params[nm[1:]] if nm.count("/") == 1 else
              params["layers"][nm.split("/")[-1]] for nm in names]
    for t in leaves:
        t.requires_grad_(True)

    def single():
        loss, _ = tf.loss_fn(params, toks, cfg)
        return float(loss.detach()), torch.autograd.grad(loss, leaves)
    loss_ref, g_ref = single()
    pp_groups = [ThreadGroup(PP_TP_STAGES) for _ in range(PP_TP)]
    tp_groups = [ThreadGroup(PP_TP) for _ in range(PP_TP_STAGES)]
    layouts = [StageLayout(pp_groups[r % PP_TP].comm(r // PP_TP),
                           tp_groups[r // PP_TP].comm(r % PP_TP), cfg)
               for r in range(n)]
    copies = []
    for lay in layouts:
        full = {k: v.detach() for k, v in params.items() if k != "layers"}
        full["layers"] = lay.stage_block({k: v.detach() for k, v in
                                          params["layers"].items()})
        copies.append({k: ({m: t.clone().requires_grad_(True)
                            for m, t in v.items()} if k == "layers"
                           else v.clone().requires_grad_(True))
                       for k, v in lay.tp_block(full).items()})
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res = pp_gang(kernels, comm_gate, Groups(pp_groups + tp_groups), n,
                  lambda r: pipeline.gpipe_lm_loss(
                      copies[r], toks, cfg, layouts[r], PP_MICRO)[0],
                  "pp gpipe tp")
    losses = res.pop("losses")
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    tp_dims = layouts[0].tp_dims
    grads = []
    for nm in names:
        leaf = nm.split("/")[-1]
        if nm.startswith("/layers/"):
            d = tp_dims["layers"][leaf]
            stages = [[copies[st * PP_TP + t]["layers"][leaf].grad
                       for t in range(PP_TP)] for st in range(PP_TP_STAGES)]
            grads.append(torch.cat([b[0] if d is None else torch.cat(b, d)
                                    for b in stages]))
        else:
            d = tp_dims[leaf]
            blocks = [copies[t][leaf].grad for t in range(PP_TP)]
            grads.append(blocks[0] if d is None else torch.cat(blocks, d))
    errs = dict(loss=max(abs(float(x.detach()) - loss_ref)
                         for x in losses) / abs(loss_ref),
                leaves=grad_errors(names, grads, g_ref))
    worst = max(errs["leaves"], key=errs["leaves"].get)
    if any(not torch.isfinite(g).all() for g in grads):
        gates.append(f"pp gpipe tp {dt}: a gradient has non-finite values")
    if not bf16 and not (errs["loss"] <= GATE_LOSS_RTOL
                         and errs["leaves"][worst] < GATE_LEAF_RTOL):
        gates.append(f"pp gpipe tp f32 against one device: {errs}")
    q = torch.empty(rows, seq, cfg.n_heads, cfg.head_dim, dtype=dtype,
                    device="meta")
    stash = flash.stash_bytes(q, q, q) <= flash.PDS_STASH_LIMIT_BYTES
    per = PP_TP_LAYERS // PP_TP_STAGES
    want = [pp_stage_launches(r // PP_TP, PP_TP_STAGES, per, PP_MICRO, stash,
                              bf16, True, embed=False) for r in range(n)]
    for r in range(n):
        if res["fwd"][r] != want[r][0]:
            gates.append(f"pp gpipe tp {dt} rank {r}: forward launches "
                         f"{res['fwd'][r]}, want {want[r][0]}")
    want_bwd = sum_counts(w[1] for w in want)
    if res["bwd"] != want_bwd:
        gates.append(f"pp gpipe tp {dt}: backward launches {res['bwd']}, "
                     f"want {want_bwd}")
    pin = collections.Counter()
    for r in range(n):
        pin.update(comm_gate.expected(
            "train/gpipe/pp2_tp2/threads", microbatches=PP_MICRO,
            stage=r // PP_TP, stages=PP_TP_STAGES))
    calls = [c for rank_calls in res["calls"] for c in rank_calls]
    calls += res["back"]
    try:
        comm_gate.assert_collective_budget(calls, dict(pin),
                                           f"pp gpipe tp {dt}")
    except AssertionError as e:
        gates.append(str(e))
    cap = comm_gate.handoff_caps(rows, seq, cfg.d_model,
                                 dtype.itemsize)["p2p"]
    if max(x for op, x in calls if op == "p2p") != cap:
        gates.append(f"pp gpipe tp {dt}: a handoff over or under one "
                     f"microbatch's activation ({cap} B)")
    out = dict(
        errors=errs, worst_leaf=worst, gated=not bf16,
        loss_rtol=GATE_LOSS_RTOL, leaf_rtol=GATE_LEAF_RTOL, stash=stash,
        launches_forward_by_rank=res["fwd"], launches_backward=res["bwd"],
        launches_total=res["total"],
        collectives=comm_gate.collective_counts(calls),
        collectives_pin=dict(pin),
        tp_gather_bytes_by_rank=[sum(x for op, x in c if op == "all-gather")
                                 for c in res["calls"]],
        host_ms=dict(forward=res["forward_ms"], backward=res["backward_ms"],
                     forward_backward=res["forward_ms"]
                     + res["backward_ms"]),
        peak_gb=peak_gb, gates=gates)
    del losses, grads, copies, res, layouts
    collect_garbage()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single()
    torch.cuda.synchronize()
    out["host_ms"]["single_device_forward_backward"] = \
        1e3 * (time.perf_counter() - t0)
    del params, leaves, g_ref, toks
    collect_garbage()
    return out


def run_pp(dev, tf, pipeline, attn_mod, flash, kernels, card: str
           ) -> dict:
    """The pp phase (see PP_STAGES): (a) `gpipe_lm_loss` on PP_STAGES
    virtual stages, one backward over the sum of the stages' losses (every
    stage's is the same; only the last's reaches the schedule), against
    one device's `tf.loss_fn` on the same weights and rows; (c) the same
    on a (pp, tp) gang (`run_pp_tp`); (b) the
    layer-stack form on PP_LS_STAGES stages with the ep phase's MoE blocks
    and loss (sum(x * dy) + aux a rank), against one device's dense route.
    The stacked leaves' gradients are the stages' blocks joined, the
    others pp rank 0's. In f32 gated (GATE_LOSS_RTOL, GATE_LEAF_RTOL), in
    bf16 recorded. Launches and collectives by rank as `pp_stage_launches`
    and the pins say; host ms of the gang and of one device (timed warm,
    after the gang), and the gang's peak GB above what the phase holds
    before it."""
    from k8s_gpu_workload_enhancer_tpu_torch.ops import embed
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import comm_gate
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.comm import ThreadGroup
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.sharding import (
        StageLayout)
    collect_garbage()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seq = TRAIN_DIMS["seq_len"]
    base_dims = dict({k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"},
                     n_kv_heads=TRAIN_DIMS["n_heads"], max_seq=seq)
    rows = TRAIN_BATCH // PP_MICRO
    gates = []
    out = dict(card=card, gpipe=dict(config=dict(
        base_dims, stages=PP_STAGES, microbatches=PP_MICRO,
        rows_a_microbatch=rows, batch=TRAIN_BATCH,
        bubble_fraction=pipeline.bubble_fraction(PP_MICRO, PP_STAGES),
        num_ticks=pipeline.num_ticks(PP_MICRO, PP_STAGES))),
        layer_stack=dict(config=dict(
            base_dims, n_layers=EP_LAYERS, n_experts=MOE_EXPERTS,
            stages=PP_LS_STAGES, rows_a_rank=EP_BATCH)),
        gpipe_tp=dict(config=dict(
            base_dims, n_layers=PP_TP_LAYERS, stages=PP_TP_STAGES, tp=PP_TP,
            microbatches=PP_MICRO, rows_a_microbatch=rows,
            batch=TRAIN_BATCH)))
    pin = comm_gate.BUDGETS["train/gpipe/pp2"]["p2p"]
    ls_pin = comm_gate.BUDGETS["train/dp2_pp2_ep2/moe"]["broadcast"]
    launches_bf16 = collections.Counter()

    def stage_copies(params, layout_rank, stages):
        """A rank's params: its stage's block of the stacked leaves and its
        own copy of the others, all leaves requiring grad."""
        mine = {k: v.detach().clone().requires_grad_(True)
                for k, v in params.items() if k != "layers"}
        k = params["layers"]["wq"].shape[0] // stages
        mine["layers"] = {
            n: v.detach()[layout_rank * k:(layout_rank + 1) * k].clone()
            .requires_grad_(True) for n, v in params["layers"].items()}
        return mine

    def joined(ranks, names):
        got = []
        for n in names:
            if n.startswith("/layers/"):
                leaf = n.split("/")[-1]
                got.append(torch.cat([r["layers"][leaf].grad for r in ranks]))
            else:
                g = ranks[0][n[1:]].grad
                got.append(g if g is not None
                           else torch.zeros_like(ranks[0][n[1:]]))
        return got

    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[-1]
        bf16 = dtype == torch.bfloat16
        # (a) The GPipe schedule.
        cfg = tf.TransformerConfig(**base_dims, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(PP_SEED)
        params = tf.init_params(gen, cfg)
        toks = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, seq + 1),
                             generator=gen, device=dev)
        names = leaf_names(params)
        leaves = [params[n[1:]] if n.count("/") == 1 else
                  params["layers"][n.split("/")[-1]] for n in names]
        for t in leaves:
            t.requires_grad_(True)

        def single():
            loss, _ = tf.loss_fn(params, toks, cfg)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        loss_ref, g_ref = single()
        copies = [stage_copies(params, r, PP_STAGES)
                  for r in range(PP_STAGES)]
        group = ThreadGroup(PP_STAGES)
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = pp_gang(kernels, comm_gate, group, PP_STAGES, lambda r:
                      pipeline.gpipe_lm_loss(
                          copies[r], toks, cfg, StageLayout(group.comm(r)),
                          PP_MICRO)[0], "pp gpipe")
        losses = res.pop("losses")
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        grads = joined(copies, names)
        errs = dict(loss=max(abs(float(x.detach()) - loss_ref)
                             for x in losses) / abs(loss_ref),
                    leaves=grad_errors(names, grads, g_ref))
        worst = max(errs["leaves"], key=errs["leaves"].get)
        if any(not torch.isfinite(g).all() for g in grads):
            gates.append(f"pp gpipe {dt}: a gradient has non-finite values")
        if not bf16 and not (errs["loss"] <= GATE_LOSS_RTOL
                             and errs["leaves"][worst] < GATE_LEAF_RTOL):
            gates.append(f"pp gpipe f32 against one device: {errs}")
        q = torch.empty(rows, seq, cfg.n_heads, cfg.head_dim, dtype=dtype,
                        device="meta")
        stash = flash.stash_bytes(q, q, q) <= flash.PDS_STASH_LIMIT_BYTES
        per = cfg.n_layers // PP_STAGES
        want = [pp_stage_launches(r, PP_STAGES, per, PP_MICRO, stash, bf16,
                                  True) for r in range(PP_STAGES)]
        for r in range(PP_STAGES):
            if res["fwd"][r] != want[r][0]:
                gates.append(f"pp gpipe {dt} stage {r}: forward launches "
                             f"{res['fwd'][r]}, want {want[r][0]}")
        want_bwd = sum_counts(w[1] for w in want)
        if res["bwd"] != want_bwd:
            gates.append(f"pp gpipe {dt}: backward launches {res['bwd']}, "
                         f"want {want_bwd}")
        cap = comm_gate.handoff_caps(rows, seq, cfg.d_model,
                                     dtype.itemsize)["p2p"]
        p2p_fwd = [[n for op, n in c if op == "p2p"] for c in res["calls"]]
        p2p_bwd = [n for op, n in res["back"] if op == "p2p"]
        pins = [pin.count(0, microbatches=PP_MICRO, stage=r,
                          stages=PP_STAGES) for r in range(PP_STAGES)]
        for r in range(PP_STAGES):
            if len(p2p_fwd[r]) != pins[r] // 2:
                gates.append(f"pp gpipe {dt} stage {r}: {len(p2p_fwd[r])} "
                             f"forward handoffs, its pin {pins[r]} is "
                             f"twice that")
        if len(p2p_bwd) != sum(pins) // 2:
            gates.append(f"pp gpipe {dt}: {len(p2p_bwd)} backward handoffs, "
                         f"want {sum(pins) // 2}")
        if max(max(x) for x in p2p_fwd) != cap or max(p2p_bwd) != cap:
            gates.append(f"pp gpipe {dt}: a handoff over or under one "
                         f"microbatch's activation ({cap} B)")
        if bf16:
            launches_bf16.update(res["total"])
        out["gpipe"][dt] = dict(
            errors=errs, worst_leaf=worst, gated=not bf16,
            loss_rtol=GATE_LOSS_RTOL, leaf_rtol=GATE_LEAF_RTOL, stash=stash,
            launches_forward_by_rank=res["fwd"], launches_backward=res["bwd"],
            p2p=dict(pins_by_rank=pins,
                     forward_by_rank=[len(x) for x in p2p_fwd],
                     backward=len(p2p_bwd), bytes_each=cap,
                     forward_bytes_by_rank=[sum(x) for x in p2p_fwd]),
            collectives_forward_by_rank=[comm_gate.collective_counts(c)
                                         for c in res["calls"]],
            host_ms=dict(forward=res["forward_ms"],
                         backward=res["backward_ms"],
                         forward_backward=res["forward_ms"]
                         + res["backward_ms"]),
            peak_gb=peak_gb)
        del losses, grads, copies, res
        collect_garbage()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single()
        torch.cuda.synchronize()
        out["gpipe"][dt]["host_ms"]["single_device_forward_backward"] = \
            1e3 * (time.perf_counter() - t0)
        del params, leaves, g_ref, toks
        collect_garbage()

        # (c) The GPipe schedule on a (pp, tp) gang.
        tp_run = run_pp_tp(dev, tf, pipeline, flash, kernels, comm_gate,
                           base_dims, dtype)
        gates += tp_run.pop("gates")
        out["gpipe_tp"][dt] = tp_run
        if bf16:
            out["gpipe_tp"]["launches"] = tp_run["launches_total"]

        # (b) The layer-stack form, MoE.
        dims = dict(base_dims, n_layers=EP_LAYERS, n_experts=MOE_EXPERTS,
                    moe_ragged_dispatch=False)
        cfg = tf.TransformerConfig(**dims, dtype=dtype)
        gen = torch.Generator(device=dev).manual_seed(PP_SEED + 1)
        params = tf.init_params(gen, cfg)
        params = {k: params[k] for k in ("embed", "layers")}
        names = ["/embed"] + [f"/layers/{k}" for k in params["layers"]]
        leaves = [params["embed"]] + list(params["layers"].values())
        for t in leaves:
            t.requires_grad_(True)
        toks = torch.randint(0, cfg.vocab_size, (EP_BATCH, seq),
                             generator=gen, device=dev)
        dy = (torch.randn(EP_BATCH, seq, cfg.d_model, generator=gen,
                          device=dev) * 1e-2).to(dtype)
        freqs = attn_mod.rope_frequencies(cfg.head_dim, cfg.max_seq,
                                          cfg.rope_theta, dev)

        def blocks(p, layout):
            x = embed.embed_tokens(p["embed"], toks, cfg.d_model, cfg.dtype)
            aux = 0.0
            for layer in range(cfg.n_layers):
                lp = (tf.layer_params(p, layer) if layout is None
                      else layout.layer_params(p, layer))
                x, a = tf._layer(x, lp, cfg, freqs, 0, layout)
                aux = aux + a
            return (x.float() * dy.float()).sum() + aux

        def single_ls():
            loss = blocks(params, None)
            return float(loss.detach()), torch.autograd.grad(loss, leaves)
        loss_ref, g_ref = single_ls()
        copies = [stage_copies(params, r, PP_LS_STAGES)
                  for r in range(PP_LS_STAGES)]
        group = ThreadGroup(PP_LS_STAGES)
        collect_garbage()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res = pp_gang(kernels, comm_gate, group, PP_LS_STAGES, lambda r:
                      blocks(copies[r], StageLayout(group.comm(r))),
                      "pp layer-stack")
        losses = res.pop("losses")
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        grads = joined(copies, names)
        errs = dict(loss=max(abs(float(x.detach()) - loss_ref)
                             for x in losses) / abs(loss_ref),
                    leaves=grad_errors(names, grads, g_ref))
        worst = max(errs["leaves"], key=errs["leaves"].get)
        if any(not torch.isfinite(g).all() for g in grads):
            gates.append(f"pp layer-stack {dt}: a gradient has non-finite "
                         f"values")
        if not bf16 and not (errs["loss"] <= GATE_LOSS_RTOL
                             and errs["leaves"][worst] < GATE_LEAF_RTOL):
            gates.append(f"pp layer-stack f32 against one device: {errs}")
        q = torch.empty(EP_BATCH, seq, cfg.n_heads, cfg.head_dim,
                        dtype=dtype, device="meta")
        stash = flash.stash_bytes(q, q, q) <= flash.PDS_STASH_LIMIT_BYTES
        fwd_want, bwd_want = pp_stage_launches(0, PP_LS_STAGES, EP_LAYERS, 1,
                                               stash, bf16, False)
        for r in range(PP_LS_STAGES):
            if res["fwd"][r] != fwd_want:
                gates.append(f"pp layer-stack {dt} rank {r}: forward "
                             f"launches {res['fwd'][r]}, want {fwd_want}")
        bwd_want = {k: v * PP_LS_STAGES for k, v in bwd_want.items()}
        if res["bwd"] != bwd_want:
            gates.append(f"pp layer-stack {dt}: backward launches "
                         f"{res['bwd']}, want {bwd_want}")
        bcasts = [[n for op, n in c if op == "broadcast"]
                  for c in res["calls"]]
        want_b = ls_pin.per_layer * EP_LAYERS
        if any(len(b) != want_b for b in bcasts):
            gates.append(f"pp layer-stack {dt}: broadcasts by rank "
                         f"{[len(b) for b in bcasts]}, want {want_b} each")
        if bf16:
            launches_bf16.update(res["total"])
        out["layer_stack"][dt] = dict(
            errors=errs, worst_leaf=worst, gated=not bf16,
            loss_rtol=GATE_LOSS_RTOL, leaf_rtol=GATE_LEAF_RTOL, stash=stash,
            launches_forward_by_rank=res["fwd"], launches_backward=res["bwd"],
            broadcasts_by_rank=[len(b) for b in bcasts],
            broadcast_bytes_by_rank=[sum(b) for b in bcasts],
            collectives_forward_by_rank=[comm_gate.collective_counts(c)
                                         for c in res["calls"]],
            host_ms=dict(forward=res["forward_ms"],
                         backward=res["backward_ms"],
                         forward_backward=res["forward_ms"]
                         + res["backward_ms"]),
            peak_gb=peak_gb)
        del losses, grads, copies, res
        collect_garbage()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        single_ls()
        torch.cuda.synchronize()
        out["layer_stack"][dt]["host_ms"]["single_device_forward_backward"] \
            = 1e3 * (time.perf_counter() - t0)
        del params, leaves, g_ref, toks, dy
        collect_garbage()
    out["launches"] = dict(launches_bf16)
    out["gates_failed"] = gates
    return out


def mesh_transcripts(prompts, new: int = MESH_NEW):
    """drive(engine): the greedy transcripts of `prompts` and the
    engine's metrics."""
    def drive(eng):
        rids = [eng.submit(list(p), new) for p in prompts]
        eng.run()
        return {"tokens": [eng.result(r).tokens for r in rids],
                "metrics": eng.metrics()}
    return drive


def ms_per_step(run: dict) -> float:
    return 1e3 * run["wall_s"] / max(1, run["decode_steps"])


def run_mesh(dev, mods, card) -> dict:
    """The serving mesh on the card at the serve defaults' full width (see
    the module note): virtual gangs of threads run the meshed programs
    (plain ops and the tp/dp collectives, no kernel), the degraded engine
    and the NCCL group of one the single-device ones."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    from k8s_gpu_workload_enhancer_tpu_torch.parallel.mesh import ServingMesh
    from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap
    collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    gates, out = [], {"card": card}
    rng = np.random.default_rng(MESH_SEED)
    v = SERVE_DIMS["vocab_size"]
    prompts = [rng.integers(0, v, MESH_PROMPT).tolist()
               for _ in range(NUM_SLOTS)]
    cfg32 = tf.TransformerConfig(**SERVE_DIMS, dtype=torch.float32)
    p32 = tf.init_params(torch.Generator(device=dev).manual_seed(0), cfg32)
    drive = mesh_transcripts(prompts)

    def gang(dp, tp, full, cfg, **kw):
        kernels.reset_launches()
        got = mesh_engine_run(ServingMesh, serving, decode, dp, tp, full,
                              cfg, dev, drive, **kw)
        if kernels.launches:
            gates.append(f"mesh ({dp}, {tp}) launched kernels "
                         f"{dict(kernels.launches)} (a mesh above one "
                         f"device runs none)")
        return got

    def one(full, cfg, **kw):
        eng = new_engine(serving, full, cfg, dev, cuda_graph=False, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = drive(eng)
        torch.cuda.synchronize()
        r["wall_s"] = time.perf_counter() - t0
        r["decode_steps"] = r["metrics"]["lifetime"]["decode_steps"]
        return r

    # Dense (2, 4), f32 (gated bit for bit) and bf16 (counted).
    want = one(p32, cfg32)
    got = gang(2, 4, p32, cfg32)
    if got["tokens"] != want["tokens"]:
        gates.append("dense (2, 4) f32 transcripts differ from one device")
    # The collective-budget gate at full width: the dense (2, 4) chunks
    # (each rank's cache holds its dp block of the slots).
    out["collective_gate"] = {"dense_2x4": chunk_gate(
        got, "serve/decode_chunk/dense", NUM_SLOTS, cfg32, 4, gates)}
    out["dense_f32"] = dict(
        equal=sum(a == b for a, b in zip(got["tokens"], want["tokens"])),
        ms_per_decode_step=ms_per_step(got),
        unmeshed_ms_per_decode_step=ms_per_step(want),
        broadcast=got["broadcast"])
    # One prefill's logits on the gang against the unmeshed forward.
    chunk = torch.as_tensor([prompts[0]], device=dev)
    ref, _ = decode.forward_cached(p32, chunk, decode.init_cache(
        cfg32, 1, cfg32.max_seq, dev), 0, cfg32)

    def prefill(mesh):
        lg, _ = decode.forward_cached(
            decode.shard_params_for_serving(p32, cfg32, mesh), chunk,
            decode.init_cache(cfg32, 1, cfg32.max_seq, dev, mesh), 0, cfg32,
            mesh=mesh)
        return float((lg - ref).abs().max())
    out["dense_f32"]["prefill_max_abs_logit_err"] = max(
        thread_gang(ServingMesh, 2, 4, prefill))
    del ref
    cfg16 = dataclasses.replace(cfg32, dtype=torch.bfloat16)
    p16 = serve._finish_params(p32, cfg16, False)
    want16 = one(p16, cfg16)
    got16 = gang(2, 4, p16, cfg16)
    out["dense_bf16"] = dict(
        equal=sum(a == b for a, b in zip(got16["tokens"], want16["tokens"])),
        of=len(prompts), ms_per_decode_step=ms_per_step(got16),
        unmeshed_ms_per_decode_step=ms_per_step(want16),
        broadcast=got16["broadcast"])
    # Paged (1, 4), f32: plain, int8 KV, spec through the oracle.
    pairs = list(zip(prompts, one(p32, cfg32, kv_block_len=KV_BLOCK_LEN)[
        "tokens"]))
    kv_keys = ("blocks_free", "blocks_used", "blocks_shared",
               "blocks_cached", "evictions_total", "prompt_tokens_total",
               "matched_tokens_total")
    out["paged_f32"] = {}
    for name, cfg, kw in (
            ("plain", cfg32, {}),
            ("int8_kv", dataclasses.replace(cfg32, kv_cache_int8=True), {}),
            ("spec", cfg32, dict(spec_k=MESH_SPEC_K,
                                 drafter=MeshOracle(pairs, v)))):
        want_p = one(p32, cfg, kv_block_len=KV_BLOCK_LEN, **kw)
        got_p = gang(1, 4, p32, cfg, kv_block_len=KV_BLOCK_LEN, **kw)
        kv_g, kv_w = got_p["metrics"]["kv_cache"], want_p["metrics"][
            "kv_cache"]
        if got_p["tokens"] != want_p["tokens"]:
            gates.append(f"paged (1, 4) {name}: transcripts differ")
        if name == "plain":
            out["collective_gate"]["paged_1x4"] = chunk_gate(
                got_p, "serve/decode_chunk/paged", NUM_SLOTS, cfg32, 4,
                gates)
        if any(kv_g[k] != kv_w[k] for k in kv_keys):
            gates.append(f"paged (1, 4) {name}: pages {kv_g} vs {kv_w}")
        rounds = got_p["metrics"]["spec"]["rounds_total"]
        if kw and not (rounds > 0 and rounds == want_p["metrics"]["spec"][
                "rounds_total"]):
            gates.append(f"paged (1, 4) spec: {rounds} verify rounds")
        out["paged_f32"][name] = dict(
            equal=sum(a == b for a, b in zip(got_p["tokens"],
                                             want_p["tokens"])),
            verify_rounds=rounds, ms_per_decode_step=ms_per_step(got_p),
            unmeshed_ms_per_decode_step=ms_per_step(want_p),
            broadcast=got_p["broadcast"])
    # MoE on the (1, 4) gang, f32: both engines at the serve defaults with
    # MOE_EXPERTS experts (each rank every expert's quarter of the MLP
    # dim), transcripts equal to the unmeshed MoE engine's; every decode
    # chunk the dense model's collectives (on one dp rank the dense
    # engine's slot gather is no call, so both engines' chunks are the
    # paged pin's).
    mcfg32 = dataclasses.replace(cfg32, n_experts=MOE_EXPERTS)
    mp32 = tf.init_params(torch.Generator(device=dev).manual_seed(0),
                          mcfg32)
    out["moe_f32"] = {}
    for name, kw in (("dense", {}), ("paged",
                                     dict(kv_block_len=KV_BLOCK_LEN))):
        want_m = one(mp32, mcfg32, **kw)
        got_m = gang(1, 4, mp32, mcfg32, **kw)
        if got_m["tokens"] != want_m["tokens"]:
            gates.append(f"moe {name} (1, 4) f32 transcripts differ from "
                         f"the unmeshed MoE engine's")
        out["moe_f32"][name] = dict(
            equal=sum(a == b for a, b in zip(got_m["tokens"],
                                             want_m["tokens"])),
            of=len(prompts), ms_per_decode_step=ms_per_step(got_m),
            unmeshed_ms_per_decode_step=ms_per_step(want_m),
            collective_gate=chunk_gate(got_m, "serve/decode_chunk/paged/moe",
                                       NUM_SLOTS, mcfg32, 4, gates))
    del mp32
    out["device_loss"] = mesh_device_loss(dev, mods, ServingMesh, faultlab,
                                          p32, cfg32, prompts, gates)
    out["host_tier"] = run_mesh_tier(dev, mods, ServingMesh, bootstrap, p32,
                                     cfg32, gates)
    del p32
    out["nccl_group_of_one"] = mesh_group_of_one(
        dev, mods, bootstrap, p16, cfg16, prompts, gates)
    out["launches"] = out["nccl_group_of_one"]["launches"]
    del p16
    # The serve main on one card refuses a mesh of 8.
    with contextlib.redirect_stderr(io.StringIO()) as err:
        try:
            serve.main(["--mesh", "2,4"])
            code = 0
        except SystemExit as e:
            code = e.code
    if code != 2 or "needs 8 devices" not in err.getvalue():
        gates.append(f"serve --mesh 2,4 exited {code}: "
                     f"{err.getvalue()[-200:]}")
    out["serve_mesh_2_4_exit"] = code
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["icibench"] = run_icibench(gates)
    out["phase_s"] = time.perf_counter() - t_phase
    out["gates_failed"] = gates
    return out


def mesh_device_loss(dev, mods, ServingMesh, faultlab, p32, cfg32, prompts,
                     gates) -> dict:
    """The JAX device-loss drill (tests/integration/test_faultlab_recovery
    .py:250-345) on the dense (2, 4) gang in f32: a device loss armed once
    the first request has 3 tokens; every live or queued request comes back
    as an `evacuate` frame that resumes on a fresh single-device engine to
    its uninterrupted transcript; the degraded engine serves one more
    request equal to the uninterrupted one and launches the single-device
    kernels (rows 1, 3, 6, 13); the serve's `mesh` block reads devices 1,
    degraded 1, shape "degraded"."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    drill = [p[:16] for p in prompts[:3]]
    kw = dict(num_slots=2)

    def uninterrupted(p):
        e = serving.ContinuousBatchEngine(
            p32, cfg32, max_seq=cfg32.max_seq, prefill_len=PREFILL_LEN,
            decode_chunk=DECODE_CHUNK, device=dev, **kw)
        r = e.submit(list(p), MESH_DRILL_NEW)
        e.run()
        return e.result(r).tokens
    wants = [uninterrupted(p) for p in drill]

    def drive(eng):
        rids = [eng.submit(list(p), MESH_DRILL_NEW) for p in drill]
        for _ in range(64):
            eng.step()
            if len(eng.result(rids[0]).tokens) >= 3:
                break
        queued = not eng.result(rids[2]).done
        faultlab.activate(faultlab.TargetedPlan({"engine.device_loss": [0]}))
        try:
            eng.step()
        finally:
            faultlab.deactivate()
        frames = [eng.result(r).resume_state for r in rids]
        res = eng.metrics()["resilience"]
        kernels.reset_launches()
        r3 = eng.submit(list(drill[0]), MESH_DRILL_NEW)
        eng.run()
        launches = dict(kernels.launches)
        svc = serve.ServeService(eng, mesh_shape=(2, 4))
        try:
            mesh = svc.metrics({})["metrics"]["mesh"]
        finally:
            svc.stop()
        return dict(queued=queued, frames=frames, resilience=res,
                    after=eng.result(r3).tokens, launches=launches,
                    mesh=mesh, degraded_mesh_none=eng.mesh is None)
    kernels.reset_launches()
    got = thread_gang(ServingMesh, 2, 4, lambda m: (
        mesh_drill_rank(m, serving, decode, p32, cfg32, dev, kw, drive)))[0]
    frames = got["frames"]
    if not got["queued"] or any(
            f is None or f["reason"] != "evacuate" for f in frames):
        gates.append(f"device loss: frames {frames}")
    res = got["resilience"]
    if (res["errors"]["device_loss"], res["evacuated_total"],
            res["mesh_degraded"]) != (1, 3, True):
        gates.append(f"device loss: resilience {res}")
    resumed = 0
    for frame, want in zip(frames, wants):
        if frame is None:
            continue
        e = serving.ContinuousBatchEngine(
            p32, cfg32, max_seq=cfg32.max_seq, prefill_len=PREFILL_LEN,
            decode_chunk=DECODE_CHUNK, device=dev, seed=7, **kw)
        r = e.submit(frame["prompt"], frame["maxNewTokens"],
                     committed=frame["committed"], prng_key=frame["prngKey"])
        e.run()
        resumed += e.result(r).tokens == want
    if resumed != len(wants):
        gates.append(f"device loss: {resumed} of {len(wants)} evacuated "
                     f"requests resumed to their transcripts")
    if got["after"] != wants[0] or not got["degraded_mesh_none"]:
        gates.append("device loss: the degraded engine's request differs")
    mesh = got["mesh"]
    if (mesh["devices"], mesh["degraded"], mesh["shape"]) != (
            1, 1, "degraded"):
        gates.append(f"device loss: mesh block {mesh}")
    rows = ("rms_norm", "rope", "flash_attention", "embed_gather")
    if any(got["launches"].get(k, 0) <= 0 for k in rows):
        gates.append(f"device loss: the degraded engine launched "
                     f"{got['launches']}")
    return dict(committed=[len(f["committed"]) for f in frames if f],
                resumed_equal=resumed, resilience=res, mesh=mesh,
                degraded_launches=got["launches"])


def mesh_drill_rank(mesh, serving, decode, p32, cfg32, dev, kw, drive):
    eng = serving.ContinuousBatchEngine(
        decode.shard_params_for_serving(p32, cfg32, mesh), cfg32,
        max_seq=cfg32.max_seq, prefill_len=PREFILL_LEN,
        decode_chunk=DECODE_CHUNK, device=dev, mesh=mesh, **kw)
    if not mesh.is_driver:
        eng.follow()
        return None
    try:
        return drive(eng)
    finally:
        eng.stop_followers()


def mesh_group_of_one(dev, mods, bootstrap, p16, cfg16, prompts,
                      gates) -> dict:
    """The paged engine on a (1, 1) mesh through an NCCL process group of
    one (`initialize_serving`, group_of_one), bf16: the single-device
    programs, kernels and graph; its tokens and launches equal the
    unmeshed engine's."""
    kernels = mods[0]
    serving = mods[7]
    runs = {}
    for name in ("unmeshed", "group_of_one"):
        ctx = mesh = None
        if name == "group_of_one":
            ctx, mesh = bootstrap.initialize_serving(
                (1, 1), {"COORDINATOR_ADDRESS": f"localhost:{free_port()}",
                         "NUM_PROCESSES": "1", "PROCESS_ID": "0"},
                device="cuda", group_of_one=True)
        try:
            eng = new_engine(serving, p16, cfg16, dev, mesh=mesh,
                             kv_block_len=KV_BLOCK_LEN)
            kernels.reset_launches()
            r = mesh_transcripts(prompts)(eng)
            runs[name] = dict(tokens=r["tokens"],
                              launches=dict(kernels.launches),
                              captures=r["metrics"]["hotpath"][
                                  "graphs_captured"],
                              lifetime=r["metrics"]["lifetime"])
            eng.stop_followers()
        finally:
            if ctx is not None:
                backend = torch.distributed.get_backend()
                ctx.close()
                runs[name]["backend"] = backend
    a, b = runs["unmeshed"], runs["group_of_one"]
    if a["tokens"] != b["tokens"]:
        gates.append("NCCL group of one: tokens differ from one device")
    rows = ("rms_norm", "rope", "flash_attention", "paged_decode",
            "embed_gather")
    if any(a["launches"].get(k, 0) != b["launches"].get(k, 0)
           or b["launches"].get(k, 0) <= 0 for k in rows):
        gates.append(f"NCCL group of one: launches {b['launches']} vs "
                     f"{a['launches']}")
    if b.get("backend") != "nccl" or b["captures"] != 1:
        gates.append(f"NCCL group of one: backend {b.get('backend')}, "
                     f"{b['captures']} captures")
    if torch.distributed.is_initialized():
        gates.append("NCCL group of one: the group was left open")
    return dict(equal=a["tokens"] == b["tokens"], backend=b.get("backend"),
                captures=b["captures"], launches=b["launches"],
                unmeshed_launches=a["launches"])


def run_tenant_drain(kernels, tf, trainer, tenant_drain, card: str) -> dict:
    """The port's CheckpointingTenantPool on the card: two tenants train
    DRAIN_BEFORE steps, drain through the pool's callbacks to a stand-in
    instance (a checkpoint each, the tenant stopped) and resume from it;
    their next DRAIN_AFTER losses must equal an undrained tenant's on the
    same data within DRAIN_RTOL (f32), and every step must launch the
    training kernels of an f32 step. It reports each drain's and resume's
    seconds (the file write and read were warm: no cache is dropped), the
    bytes each checkpoint holds, and the f32 step time."""
    class Instance:
        def __init__(self, instance_id):
            self.instance_id = instance_id

    freed_gb = collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    mcfg = tf.TransformerConfig(**DRAIN_DIMS, dtype=torch.float32)
    tcfg = trainer.TrainConfig(batch_size=DRAIN_BATCH,
                               seq_len=DRAIN_DIMS["max_seq"],
                               warmup_steps=1, total_steps=100)
    with tempfile.TemporaryDirectory(prefix="ktwe-drain-") as root:
        pool = tenant_drain.CheckpointingTenantPool(
            os.path.join(root, "pool"), device="cuda")
        ref = tenant_drain.CheckpointingTenantPool(
            os.path.join(root, "ref"), device="cuda")
        kernels.reset_launches()
        t0 = time.perf_counter()
        tenants = ("t-0", "t-1")
        for uid in tenants:
            pool.launch(uid, mcfg, tcfg)
            pool.step(uid, DRAIN_BEFORE)
        ref.launch("undrained", mcfg, tcfg)
        ref.step("undrained", DRAIN_BEFORE)
        torch.cuda.synchronize()
        launch_and_steps_s = time.perf_counter() - t0
        cbs = pool.callbacks()
        drain_s, resume_s, ckpt_bytes = {}, {}, {}
        for uid in tenants:
            t = time.perf_counter()
            if not cbs.checkpoint(uid, Instance(f"old-{uid}")):
                fail(f"tenant_drain: the pool refused to drain {uid}")
            drain_s[uid] = time.perf_counter() - t
            if pool.is_live(uid):
                fail(f"tenant_drain: {uid} still live after its drain")
            ckpt = os.path.join(root, "pool", uid)
            ckpt_bytes[uid] = sum(os.path.getsize(os.path.join(ckpt, f))
                                  for f in os.listdir(ckpt))
        for uid in tenants:
            t = time.perf_counter()
            cbs.resume(uid, Instance(f"new-{uid}"))
            resume_s[uid] = time.perf_counter() - t
            if not pool.is_live(uid) or pool.steps_done(uid) != DRAIN_BEFORE:
                fail(f"tenant_drain: {uid} resumed at "
                     f"{pool.steps_done(uid)}, want {DRAIN_BEFORE}")
        want = [ref.step("undrained") for _ in range(DRAIN_AFTER)]
        got = {uid: [pool.step(uid) for _ in range(DRAIN_AFTER)]
               for uid in tenants}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    rel = {uid: [abs(a - b) / abs(b) for a, b in zip(g, want)]
           for uid, g in got.items()}
    if max(max(r) for r in rel.values()) > DRAIN_RTOL:
        fail(f"tenant_drain: losses after resume {got}, undrained {want}")
    steps = 3 * (DRAIN_BEFORE + DRAIN_AFTER)
    # stash: the f32 p/ds stash at DRAIN_BATCH is under its gate (above).
    want_launches = per_step_launches(
        DRAIN_DIMS["n_layers"], stash=True, bf16=False,
        head_dim=DRAIN_DIMS["d_model"] // DRAIN_DIMS["n_heads"])
    want_launches = {k: n * steps for k, n in want_launches.items()}
    if launches != want_launches:
        fail(f"tenant_drain launched {launches}, its {steps} steps need "
             f"{want_launches}")
    return dict(card=card, config=dict(DRAIN_DIMS, batch=DRAIN_BATCH,
                                       dtype="float32"),
                tenants=len(tenants), losses_after_resume=got,
                undrained_losses=want, rel_err=rel, rtol=DRAIN_RTOL,
                drain_s=drain_s, resume_s=resume_s, ckpt_bytes=ckpt_bytes,
                drain_gb_per_s={u: ckpt_bytes[u] / drain_s[u] / 1e9
                                for u in tenants},
                resume_gb_per_s={u: ckpt_bytes[u] / resume_s[u] / 1e9
                                 for u in tenants},
                launch_and_steps_s=launch_and_steps_s,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, freed_by_gc_collect_gb=freed_gb, wall_s=wall,
                launches=launches)


def collect_garbage() -> float:
    """gc.collect() before a phase's peak reset, so garbage that earlier
    phases left in reference cycles does not count; returns the GB of
    device memory it freed."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    return (before - torch.cuda.memory_allocated()) / 1e9


def run_flagship(kernels, trainer, flagship) -> dict:
    """train.trainer.train_loop on the flagship configuration at full width
    and depth (bf16 on the card), cut to batch 32 (4 microbatches of 8) a
    step; launch counters set to 0 just before it and read after every
    step and when it returns."""
    freed_gb = collect_garbage()
    torch.cuda.reset_peak_memory_stats()
    model_cfg, train_cfg = flagship.flagship_configs(
        batch_size=FLAGSHIP_BATCH, grad_accum=FLAGSHIP_ACCUM)
    snaps, losses, gnorms = [], [], []

    def on_step(i, metrics):
        snaps.append(dict(kernels.launches))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = trainer.train_loop(model_cfg, train_cfg, num_steps=FLAGSHIP_STEPS,
                             callback=on_step, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    want = per_step_launches(model_cfg.n_layers, stash=True, flagship=True,
                             microbatches=FLAGSHIP_ACCUM,
                             head_dim=model_cfg.d_model // model_cfg.n_heads)
    per_step = step_launches(snaps, launches, want, "flagship")
    if len(snaps) != FLAGSHIP_STEPS:
        fail(f"the flagship ran {len(snaps)} steps, want {FLAGSHIP_STEPS}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"flagship losses {losses} or grad norms {gnorms} not finite")
    return dict(config=dict(model=dict(
                    vocab_size=model_cfg.vocab_size,
                    d_model=model_cfg.d_model, n_layers=model_cfg.n_layers,
                    n_heads=model_cfg.n_heads, d_ff=model_cfg.d_ff,
                    ce_chunk=model_cfg.ce_chunk,
                    ce_cache_logits=model_cfg.ce_cache_logits),
                    seq_len=train_cfg.seq_len, batch=train_cfg.batch_size,
                    grad_accum=train_cfg.grad_accum,
                    microbatch=train_cfg.microbatch_size, dtype="bfloat16"),
                steps=FLAGSHIP_STEPS, timed_steps=res["steps"], wall_s=wall,
                step_ms=res["avg_step_s"] * 1e3,
                tokens_per_s=res["tokens_per_s"],
                achieved_tflops=res["achieved_tflops"],
                mfu_pct=res["mfu_pct"], mfu_peak_tflops=989.0,
                max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                / 1e9, freed_by_gc_collect_gb=freed_gb,
                losses=losses, grad_norms=gnorms,
                launches_per_step=per_step[0], launches=launches)


# ---------------------------------------------------------------------------
# Phase 5b: checkpoints in and out
# ---------------------------------------------------------------------------


def ckpt_trainer_argv(shard: str, steps: int, ckpt: str = "",
                      resume: bool = False) -> list:
    """The trainer main at the serve dims (the model the serve main then
    loads), seq 256 (the serve max_seq), batch 8, on the token shard."""
    d = SERVE_DIMS
    argv = ["--device", "cuda", "--vocab-size", str(d["vocab_size"]),
            "--d-model", str(d["d_model"]), "--n-layers", str(d["n_layers"]),
            "--n-heads", str(d["n_heads"]), "--d-ff", str(d["d_ff"]),
            "--seq-len", str(d["max_seq"]), "--batch-size", str(CKPT_BATCH),
            "--seed", "0", "--steps", str(steps)]
    if shard:
        argv += ["--data-file", shard]
    if ckpt:
        argv += ["--checkpoint-dir", ckpt]
    if resume:
        argv += ["--resume"]
    return argv


def run_ckpt_trainer(trainer_cli, kernels, argv, on_step=None) -> dict:
    """One trainer main run with the launch counters set to 0 just before
    it; every step must launch exactly the t-layout path's kernels (head_dim
    512, the p/ds stash, plain-torch CE) and nothing may launch outside the
    steps."""
    snaps, idx, losses, gnorms = [], [], [], []

    def cb(i, metrics):
        snaps.append(dict(kernels.launches))
        idx.append(i)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if on_step is not None:
            on_step(i)
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        rc = trainer_cli.main(argv, callback=cb)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    if rc != 0:
        fail(f"trainer main {argv} exited {rc}")
    want = per_step_launches(SERVE_DIMS["n_layers"], stash=True,
                             flagship=True, fused_ce=False,
                             head_dim=CKPT_HEAD_DIM)
    step_launches(snaps, launches, want, f"checkpoint trainer {argv}")
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        fail(f"checkpoint trainer losses {losses} or grad norms {gnorms}")
    text = buf.getvalue()
    lines = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    return dict(steps=idx, losses=losses, grad_norms=gnorms,
                launches=launches, last=lines[-1] if lines else {},
                text=text)


def equal_checkpoints(a: str, b: str) -> dict:
    """Two checkpoint files, bit for bit: step, count and every tensor of
    params, mu and nu (bitwise, NaN patterns included)."""
    x = torch.load(a, map_location="cpu", weights_only=True, mmap=True)
    y = torch.load(b, map_location="cpu", weights_only=True, mmap=True)
    diffs = []
    if x["step"] != y["step"] or (x["opt_state"]["count"]
                                  != y["opt_state"]["count"]):
        diffs.append(f"step/count {x['step']}/{x['opt_state']['count']} vs "
                     f"{y['step']}/{y['opt_state']['count']}")
    for part, tx, ty in (("params", x["params"], y["params"]),
                         ("mu", x["opt_state"]["mu"], y["opt_state"]["mu"]),
                         ("nu", x["opt_state"]["nu"], y["opt_state"]["nu"])):
        for name, u, v in zip(leaf_names(tx), _leaves(tx), _leaves(ty)):
            if not torch.equal(u.view(torch.int32), v.view(torch.int32)):
                n = int((u.view(torch.int32) != v.view(torch.int32)).sum())
                diffs.append(f"{part}{name}: {n} of {u.numel()} differ")
    return dict(step=x["step"], count=x["opt_state"]["count"],
                leaves=3 * len(_leaves(x["params"])), diffs=diffs)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def post_json(port: int, path: str, body: dict, timeout: float = 300,
              headers=None):
    """(status, reply) of a POST; an HTTP error's status and JSON body."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get_metrics(port: int, headers=None) -> dict:
    code, reply = get_json(port, "/v1/metrics", headers)
    if code != 200:
        fail(f"/v1/metrics answered {code} {reply}")
    return reply["metrics"]


def reference_tokens(serve, argv, params, prompts) -> list:
    """Greedy tokens of an in-process engine built as the serve main builds
    its own (same flags) on `params`, the prompts one after another."""
    eng = serve.make_engine(serve.build_parser().parse_args(argv), params)
    out = []
    for prompt in prompts:
        rid = eng.submit(prompt, CKPT_NEW_TOKENS)
        eng.run()
        out.append(eng.result(rid).tokens)
    del eng
    return out


def ckpt_serve(serve, kernels, argv, prompts, later_dir, other_dir,
               want_before, want_after, pfx) -> dict:
    """The serve main from --checkpoint-dir: the prompts answer as the
    reference engine on the checkpoint; a prefix `pfx` = (prefix, suffix)
    is registered and a prefixId request answers as the full prompt
    (the last entry of want_*); a reload to `later_dir` with the prefix
    registered answers 200 with its step, then the prefixId request
    answers as the full prompt on the new weights (the swap re-prefilled
    the prefix); the prefix is released and the same reload repeated
    without one (the pause without a prefix); a reload of another model's
    checkpoint answers 409 and changes nothing; the prompts answer as the
    new weights; one decode graph capture serves both reloads. Paged: the
    prompts share a prefix, and no page is leaked."""
    stop, ready, got_port, rc = threading.Event(), {}, threading.Event(), {}

    def on_ready(port):
        ready["port"] = port
        got_port.set()
    buf = io.StringIO()
    kernels.reset_launches()
    th = threading.Thread(target=lambda: rc.update(rc=serve.main(
        argv, stop=stop, on_ready=on_ready)), daemon=True)
    with contextlib.redirect_stdout(buf):
        th.start()
        try:
            if not got_port.wait(600):
                fail("checkpoint serve main did not come up")
            port = ready["port"]
            start_kv = get_metrics(port)["kv_cache"]

            def answer(body):
                code, r = post_json(port, "/v1/generate", dict(
                    body, maxNewTokens=CKPT_NEW_TOKENS, timeoutSeconds=300))
                if code != 200 or r.get("status") != "ok":
                    fail(f"checkpoint serve /v1/generate: {code} {r}")
                return r["tokens"]

            def answers():
                return [answer({"prompt": p}) for p in prompts]
            before = answers()
            code, reg = post_json(port, "/v1/prefix", {"tokens": pfx[0]})
            if code != 200:
                fail(f"checkpoint serve /v1/prefix: {code} {reg}")
            by_prefix = {"prompt": pfx[1], "prefixId": reg["prefixId"]}
            prefix_before = answer(by_prefix)
            code, good = post_json(port, "/v1/admin/reload",
                                   {"checkpointDir": later_dir})
            prefix_after = answer(by_prefix)
            code_rel, _ = post_json(port, "/v1/prefix",
                                    {"releaseId": reg["prefixId"]})
            code_plain, plain = post_json(port, "/v1/admin/reload",
                                          {"checkpointDir": later_dir})
            code_bad, bad = post_json(port, "/v1/admin/reload",
                                      {"checkpointDir": other_dir})
            after = answers()
            metrics = get_metrics(port)
        finally:
            stop.set()
            th.join(120)
    text = buf.getvalue()
    launches = dict(kernels.launches)
    if th.is_alive() or rc.get("rc") != 0:
        fail(f"checkpoint serve main did not drain and exit 0: {rc}")
    if "restored params from step" not in text:
        fail(f"checkpoint serve main printed no restore line: {text}")
    if before != want_before[:-1] or prefix_before != want_before[-1]:
        fail(f"checkpoint serve tokens {before}, by prefix {prefix_before} "
             f"differ from the engine on the same checkpoint {want_before}")
    if code != 200 or good.get("status") != "ok" or code_plain != 200 \
            or code_rel != 200:
        fail(f"/v1/admin/reload to {later_dir}: {code} {good}, again "
             f"without the prefix {code_plain} {plain}")
    if prefix_after != want_after[-1]:
        fail(f"after the reload the prefix request gave {prefix_after}, the "
             f"full prompt on the new weights {want_after[-1]}")
    if code_bad != 409:
        fail(f"/v1/admin/reload of another model answered {code_bad} "
             f"{bad}, want 409")
    if after != want_after[:-1]:
        fail(f"after the reload the serve gave {after}, the engine on the "
             f"new weights {want_after}")
    if metrics["hotpath"]["graphs_captured"] != 1:
        fail(f"the checkpoint serve main captured "
             f"{metrics['hotpath']['graphs_captured']} decode graphs over "
             f"two reloads, want 1 (a swap copies into the captured "
             f"storage)")
    kv = metrics["kv_cache"]
    leaked = 0
    if kv["paged"]:
        leaked = start_kv["blocks_free"] - kv["blocks_free"] \
            - kv["blocks_cached"]
        if leaked or kv["blocks_used"] != kv["blocks_cached"] \
                or kv["matched_tokens_total"] < 2 * SHARED_PREFIX:
            fail(f"paged checkpoint serve: {leaked} pages leaked or no "
                 f"prefix reuse: start {start_kv}, end {kv}")
    return dict(argv=argv, restored_line=[x for x in text.splitlines()
                                          if "restored params" in x],
                reload_step=good["step"],
                swap_pause_ms_with_prefix=good["swapPauseMs"],
                swap_pause_ms=plain["swapPauseMs"],
                prefix_cached_tokens=reg["cachedTokens"],
                other_model_reload=dict(status=code_bad,
                                        error=bad.get("error", "")[:200]),
                weight_swaps=metrics["resilience"]["weight_swaps"],
                graphs_captured=metrics["hotpath"]["graphs_captured"],
                requests_completed=metrics["requests_completed"],
                lifetime=metrics["lifetime"],
                kv_cache={k: kv[k] for k in ("paged", "blocks_free",
                                             "blocks_cached", "blocks_used",
                                             "matched_tokens_total")},
                pages_leaked=leaked, launches=launches)


def run_checkpoint(dev, kernels, trainer_cli, serve, tf, trainer, ckpt,
                   data) -> dict:
    """Train at the serve width on a token shard through the trainer main,
    save, resume bit for bit, drain, then serve the checkpoint and hot-swap
    it on the dense and the paged serve main. Checkpoints live in a
    temporary directory, removed at the end, with at most two full ones on
    disk at once."""
    root = tempfile.mkdtemp(prefix="ktwe-ckpt-smoke-")
    try:
        return _checkpoint_phase(dev, kernels, trainer_cli, serve, tf,
                                 trainer, ckpt, data, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _checkpoint_phase(dev, kernels, trainer_cli, serve, tf, trainer, ckpt,
                      data, root) -> dict:
    shard = os.path.join(root, "tokens.bin")
    vocab = SERVE_DIMS["vocab_size"]
    data.write_token_file(shard, np.random.default_rng(13).integers(
        0, vocab, CKPT_WINDOWS * (SERVE_DIMS["max_seq"] + 1)))
    dir_a, dir_b = os.path.join(root, "a"), os.path.join(root, "b")
    out = {"config": dict(SERVE_DIMS, batch=CKPT_BATCH, dtype="bfloat16",
                          shard_windows=CKPT_WINDOWS,
                          shard_bytes=os.path.getsize(shard))}
    # 1. Resume is exact: B trains 2 steps and saves, a second main resumes
    # and trains step 3; A trains 3 steps straight.
    freed_gb = collect_garbage()
    b1 = run_ckpt_trainer(trainer_cli, kernels,
                          ckpt_trainer_argv(shard, 2, dir_b))
    b2 = run_ckpt_trainer(trainer_cli, kernels,
                          ckpt_trainer_argv(shard, 3, dir_b, resume=True))
    if "resumed from step 2" not in b2["text"] or b2["steps"] != [2]:
        fail(f"the resumed trainer did not resume at step 2: {b2['text']}")
    os.unlink(os.path.join(dir_b, "ckpt-2.pt"))
    path_b3 = os.path.join(dir_b, "ckpt-3.pt")
    out["checkpoint_bytes"] = os.path.getsize(path_b3)
    # Save and restore times at this width, on the resumed state.
    cfg = tf.TransformerConfig(**SERVE_DIMS, dtype=torch.bfloat16)
    tcfg = trainer.TrainConfig(batch_size=CKPT_BATCH,
                               seq_len=SERVE_DIMS["max_seq"])
    target = trainer.init_state(cfg, tcfg,
                                torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ckpt.CheckpointManager(dir_b).restore(None, target)
    torch.cuda.synchronize()
    out["restore_full_s"] = time.perf_counter() - t0
    del target
    dir_t = os.path.join(root, "timing")
    mgr = ckpt.CheckpointManager(dir_t)
    t0 = time.perf_counter()
    mgr.save(state.step, state, wait=True)
    out["save_wait_s"] = time.perf_counter() - t0
    shutil.rmtree(dir_t)
    mgr = ckpt.CheckpointManager(dir_t)
    t0 = time.perf_counter()
    mgr.save(state.step, state, wait=False)
    out["save_nowait_return_s"] = time.perf_counter() - t0
    mgr.close()
    out["save_nowait_total_s"] = time.perf_counter() - t0
    shutil.rmtree(dir_t)
    del state, mgr
    collect_garbage()
    a = run_ckpt_trainer(trainer_cli, kernels,
                         ckpt_trainer_argv(shard, 3, dir_a))
    same = equal_checkpoints(os.path.join(dir_a, "ckpt-3.pt"), path_b3)
    shutil.rmtree(dir_a)
    metrics_equal = (a["losses"][2] == b2["losses"][0]
                     and a["grad_norms"][2] == b2["grad_norms"][0])
    if same["diffs"] or same["step"] != 3 or not metrics_equal:
        fail(f"resume is not bit for bit: step 3 loss/grad norm straight "
             f"{a['losses'][2]}/{a['grad_norms'][2]}, resumed "
             f"{b2['losses'][0]}/{b2['grad_norms'][0]}; "
             f"{same['diffs'][:20]}")
    out["resume"] = dict(straight_losses=a["losses"],
                         straight_grad_norms=a["grad_norms"],
                         resumed_losses=b1["losses"] + b2["losses"],
                         resumed_grad_norms=b1["grad_norms"]
                         + b2["grad_norms"],
                         leaves_compared=same["leaves"], bit_for_bit=True)
    out["step_ms_data_file"] = a["last"]["avg_step_s"] * 1e3
    synthetic = run_ckpt_trainer(trainer_cli, kernels,
                                 ckpt_trainer_argv("", 3))
    out["step_ms_synthetic"] = synthetic["last"]["avg_step_s"] * 1e3
    out["freed_by_gc_collect_gb"] = freed_gb
    launches = {}
    for run in (b1, b2, a, synthetic):
        for k, n in run["launches"].items():
            launches[k] = launches.get(k, 0) + n
    # 2. Drain: SIGTERM after the first resumed step leaves a checkpoint at
    # the drained step and the marker.
    d = run_ckpt_trainer(
        trainer_cli, kernels, ckpt_trainer_argv(shard, 10, dir_b,
                                                resume=True),
        on_step=lambda i: os.kill(os.getpid(), signal.SIGTERM))
    for k, n in d["launches"].items():
        launches[k] = launches.get(k, 0) + n
    marker = ckpt.read_drain_marker(dir_b)
    if (d["steps"] != [3] or d["last"].get("drained") is not True
            or d["last"].get("step") != 4 or marker is None
            or marker.get("step") != 4
            or ckpt.CheckpointManager(dir_b).latest_step() != 4):
        fail(f"drain: steps {d['steps']}, line {d['last']}, marker {marker}")
    out["drain"] = dict(drained_line=d["last"], marker_step=marker["step"])
    out["train_launches"] = launches
    # 3-4. Serve step 3, hot-swap to step 4 (moved to its own directory)
    # and refuse another model's checkpoint.
    dir_later = os.path.join(root, "later")
    os.makedirs(dir_later)
    os.rename(os.path.join(dir_b, "ckpt-4.pt"),
              os.path.join(dir_later, "ckpt-4.pt"))
    dir_other = os.path.join(root, "other")
    small = tf.TransformerConfig(vocab_size=vocab, d_model=256, n_layers=1,
                                 n_heads=2, n_kv_heads=2, d_ff=512,
                                 max_seq=SERVE_DIMS["max_seq"])
    ckpt.CheckpointManager(dir_other).save(5, trainer.init_state(
        small, tcfg, torch.Generator(device=dev).manual_seed(1)))
    serve_argv = ["--device", "cuda", "--port", "0", "--seed", "0",
                  "--checkpoint-dir", dir_b]
    collect_garbage()
    baseline = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loader = serve.make_params_loader(cfg, "", False, dev)
    t0 = time.perf_counter()
    params3, step3 = loader(dir_b)
    torch.cuda.synchronize()
    out["restore_params_only_s"] = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - baseline
    bf16_bytes = sum(t.numel() * t.element_size()
                     for t in trainer.tree_leaves(params3))
    f32_leaf = max(t.numel() * 4 for t in trainer.tree_leaves(params3))
    out["serve_load"] = dict(step=step3, peak_gb=peak / 1e9,
                             params_bf16_gb=bf16_bytes / 1e9,
                             largest_f32_leaf_gb=f32_leaf / 1e9)
    if step3 != 3 or peak > bf16_bytes + f32_leaf + (1 << 20):
        fail(f"serve load: step {step3}, peak {peak} B over the bf16 params "
             f"{bf16_bytes} B plus one f32 leaf {f32_leaf} B")
    params4, _ = loader(dir_later)
    rng = np.random.default_rng(21)
    dense_prompts = [rng.integers(0, vocab, n).tolist()
                     for n in (16, PREFILL_LEN + 32)]
    prefix = rng.integers(0, vocab, SHARED_PREFIX).tolist()
    paged_prompts = [prefix + rng.integers(0, vocab, 16).tolist()
                     for _ in range(2)]
    # A registered prefix of FLEET_PREFIX tokens no other prompt shares (so
    # its registration prefills every chunk) and a suffix.
    pfx = (rng.integers(0, vocab, FLEET_PREFIX).tolist(),
           rng.integers(0, vocab, FLEET_SUFFIX).tolist())
    paged_argv = serve_argv + ["--kv-block-len", str(KV_BLOCK_LEN)]
    want = {}
    for name, argv, prompts in (("dense", serve_argv, dense_prompts),
                                ("paged", paged_argv, paged_prompts)):
        want[name] = [reference_tokens(serve, argv, p,
                                       prompts + [pfx[0] + pfx[1]])
                      for p in (params3, params4)]
    del params3, params4
    collect_garbage()
    out["serve"] = ckpt_serve(serve, kernels, serve_argv, dense_prompts,
                              dir_later, dir_other, *want["dense"], pfx)
    out["paged_serve"] = ckpt_serve(serve, kernels, paged_argv,
                                    paged_prompts, dir_later, dir_other,
                                    *want["paged"], pfx)
    for phase in ("serve", "paged_serve"):
        got = out[phase]["launches"]
        paged = phase == "paged_serve"
        # The registration's chunks and the swap's re-prefill of the
        # prefix (the first reload; the second runs without a prefix).
        life = dict(out[phase]["lifetime"])
        life["prefill_chunks"] += 2 * prefix_chunks(FLEET_PREFIX, paged)
        exp = expected_launches(SERVE_DIMS["n_layers"], life, paged=paged)
        if got != exp:
            fail(f"checkpoint {phase} launches {got}, its chunks and steps "
                 f"need {exp}")
    return out


# ---------------------------------------------------------------------------
# Phase 5b: the serve surface the fleet calls
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def get_json(port: int, path: str, headers=None):
    """(status, reply) of a GET; an HTTP error's status and JSON body."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class ServeMain:
    """serve.main(argv) in a thread, up at `port`; close() stops it and
    fails unless it drained and returned 0."""

    def __init__(self, serve, argv):
        self.stop, self.rc, ready, up = (threading.Event(), {}, {},
                                         threading.Event())

        def on_ready(port):
            ready["port"] = port
            up.set()
        self.thread = threading.Thread(target=lambda: self.rc.update(
            rc=serve.main(argv, stop=self.stop, on_ready=on_ready)),
            daemon=True)
        self.thread.start()
        if not up.wait(600):
            fail(f"serve main {argv} did not come up")
        self.port = ready["port"]

    def close(self):
        self.stop.set()
        self.thread.join(120)
        if self.thread.is_alive() or self.rc.get("rc") != 0:
            fail(f"serve main did not drain and exit 0: {self.rc}")


class Stream:
    """A streamed /v1/generate (submitted when the constructor returns),
    read in a thread: `lines` grows as they arrive (`times`: the
    perf_counter of each arrival), `done` is set after the last."""

    def __init__(self, port: int, body: dict, headers=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps(dict(body, stream=True,
                                 timeoutSeconds=300)).encode(),
            headers={"Content-Type": "application/json", **(headers or {})},
            method="POST")
        self.resp = urllib.request.urlopen(req, timeout=300)
        self.lines, self.times, self.done = [], [], threading.Event()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        try:
            for raw in self.resp:
                self.times.append(time.perf_counter())
                self.lines.append(json.loads(raw))
        finally:
            self.resp.close()
            self.done.set()

    def tokens(self) -> list:
        return [t for x in list(self.lines) if "status" not in x
                for t in x["tokens"]]

    def final(self) -> dict:
        if not self.done.wait(300) or "status" not in self.lines[-1]:
            fail(f"stream did not end with a final view: {self.lines[-3:]}")
        return self.lines[-1]


def concurrent(port: int, bodies: list) -> list:
    """Blocking /v1/generate replies of `bodies`, sent at once."""
    out = [None] * len(bodies)

    def send(i):
        out[i] = post_json(port, "/v1/generate",
                           dict(bodies[i], timeoutSeconds=300))
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    for code, r in out:
        if code != 200 or r.get("status") != "ok":
            fail(f"/v1/generate: {code} {r}")
    return [r for _, r in out]


def wait_streamed(streams, n: int) -> None:
    """Until each stream has streamed n tokens; fail if one ends first."""
    deadline = time.time() + 300
    while not all(len(s.tokens()) >= n for s in streams):
        if any(s.done.is_set() for s in streams) or time.time() > deadline:
            fail(f"a stream ended (or stalled) before {n} tokens: "
                 f"{[s.lines[-1:] for s in streams]}")
        time.sleep(0.001)


def splice(a: Stream, b: Stream, want: list, what: str) -> int:
    """A's stream ends in a migrate frame, B's resumes it: offsets
    contiguous from 0 across both, no token repeated or lost, and the
    spliced tokens equal `want`. Returns the committed length."""
    final_a, final_b = a.final(), b.final()
    if final_a.get("status") != "migrate" or "resume" not in final_a:
        fail(f"{what}: the ejected stream ended {final_a}")
    committed = final_a["resume"]["committed"]
    seen, toks = 0, []
    for x in a.lines[:-1] + b.lines[:-1]:
        if x["offset"] != seen:
            fail(f"{what}: offset {x['offset']} where {seen} was due")
        toks += x["tokens"]
        seen += len(x["tokens"])
    if a.tokens() != committed or final_b.get("status") != "ok" \
            or final_b.get("committedOffset") != len(committed):
        fail(f"{what}: streamed {a.tokens()}, committed {committed}, "
             f"resumed final {final_b}")
    if toks != want:
        first = next((i for i, (x, y) in enumerate(zip(toks, want))
                      if x != y), min(len(toks), len(want)))
        fail(f"{what}: the spliced stream differs from the uninterrupted "
             f"one at token {first} (committed {len(committed)}): "
             f"{toks} vs {want}")
    return len(committed)


def scrape(port: int, families) -> dict:
    """GET /metrics of a --metrics-port: every line a `# TYPE name kind`
    or `name value`, every family one of `families`."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as resp:
        text = resp.read().decode()
    series = {}
    for line in text.splitlines():
        parts = line.split()
        if line.startswith("# TYPE "):
            if len(parts) != 4 or parts[3] not in ("counter", "gauge"):
                fail(f"metrics port: bad TYPE line {line!r}")
        elif len(parts) != 2 or parts[0] not in families:
            fail(f"metrics port: bad line {line!r}")
        else:
            series[parts[0]] = float(parts[1])
    if set(series) != set(families):
        fail(f"metrics port served {sorted(series)}")
    return series


def run_fleet(serve, kernels, paged: bool = False) -> dict:
    """Two serve mains A and B at the serve defaults on the same seeded
    weights (paged: pages of 16), each with a --metrics-port, with the
    launch counters set to 0 just before they start and read after they
    exit; the fleet's routes driven between them (fleet_phase)."""
    base = ["--device", "cuda", "--port", "0", "--seed", "0"]
    if paged:
        base += ["--kv-block-len", str(KV_BLOCK_LEN)]
    mports = [free_port(), free_port()]
    buf = io.StringIO()
    kernels.reset_launches()
    with contextlib.redirect_stdout(buf):
        a = ServeMain(serve, base + ["--metrics-port", str(mports[0])])
        b = ServeMain(serve, base + ["--metrics-port", str(mports[1])])
        try:
            out = fleet_phase(serve, a.port, b.port, mports, paged)
        finally:
            a.close()
            b.close()
    launches = dict(kernels.launches)
    life = {k: out["lifetime_a"][k] + out["lifetime_b"][k]
            for k in ("prefill_chunks", "decode_steps")}
    life["prefill_chunks"] += prefix_chunks(FLEET_PREFIX, paged)
    want = expected_launches(SERVE_DIMS["n_layers"], life, paged=paged)
    if launches != want:
        fail(f"fleet ({'paged' if paged else 'dense'}) launches {launches}, "
             f"its chunks and steps need {want}")
    out["launches"] = launches
    return out


def fleet_phase(serve, pa: int, pb: int, mports, paged: bool) -> dict:
    vocab, max_seq = SERVE_DIMS["vocab_size"], SERVE_DIMS["max_seq"]
    rng = np.random.default_rng(31 + paged)
    out = {"paged": paged}
    kv0 = get_metrics(pa)["kv_cache"]
    # 1. A registered prefix against the full prompts on B.
    prefix = rng.integers(0, vocab, FLEET_PREFIX).tolist()
    suffixes = [rng.integers(0, vocab, FLEET_SUFFIX).tolist()
                for _ in range(NUM_SLOTS)]
    code, reg = post_json(pa, "/v1/prefix", {"tokens": prefix})
    cached = (FLEET_PREFIX if paged
              else FLEET_PREFIX // PREFILL_LEN * PREFILL_LEN)
    if code != 200 or reg.get("cachedTokens") != cached:
        fail(f"/v1/prefix: {code} {reg}, want {cached} cached tokens")
    chunks0 = [get_metrics(p)["lifetime"]["prefill_chunks"]
               for p in (pa, pb)]
    by_prefix = concurrent(pa, [{"prompt": sfx, "prefixId": reg["prefixId"],
                                 "maxNewTokens": FLEET_NEW}
                                for sfx in suffixes])
    full = concurrent(pb, [{"prompt": prefix + sfx,
                            "maxNewTokens": FLEET_NEW} for sfx in suffixes])
    for i, (x, y) in enumerate(zip(by_prefix, full)):
        if x["tokens"] != y["tokens"] or len(x["tokens"]) != FLEET_NEW:
            fail(f"prefix request {i} gave {x['tokens']}, the full prompt "
                 f"{y['tokens']}")
    chunks = [get_metrics(p)["lifetime"]["prefill_chunks"] - c
              for p, c in zip((pa, pb), chunks0)]
    code, rel = post_json(pa, "/v1/prefix", {"releaseId": reg["prefixId"]})
    m = get_metrics(pa)
    if code != 200 or m["prefix_cache"] != {
            "registered": 0, "hits": NUM_SLOTS,
            "prompt_tokens_saved": NUM_SLOTS * cached}:
        fail(f"prefix release: {code} {rel}, {m['prefix_cache']}")
    out["prefix"] = dict(
        prefix_tokens=FLEET_PREFIX, cached_tokens=cached,
        requests=NUM_SLOTS, suffix_tokens=FLEET_SUFFIX, new_tokens=FLEET_NEW,
        ttft_p50_ms_prefix=float(np.median([r["ttftMs"] for r in by_prefix])),
        ttft_p50_ms_full=float(np.median([r["ttftMs"] for r in full])),
        prefill_chunks_prefix=chunks[0], prefill_chunks_full=chunks[1],
        prefill_chunks_saved=chunks[1] - chunks[0],
        registration_chunks=prefix_chunks(FLEET_PREFIX, paged),
        tokens_equal=True)
    if paged:
        # The released chain is cold: requests that fill the whole pool
        # evict it with every other cached page, none is deferred, and
        # when they end the pool holds what it held before registration.
        kv1 = m["kv_cache"]
        concurrent(pa, [{"prompt": rng.integers(0, vocab, FLUSH_PROMPT)
                         .tolist(), "maxNewTokens": max_seq - FLUSH_PROMPT}
                        for _ in range(NUM_SLOTS)])
        kv2 = get_metrics(pa)["kv_cache"]
        evicted = kv2["evictions_total"] - kv1["evictions_total"]
        if kv2["blocks_used"] != kv0["blocks_used"] \
                or kv2["deferrals_total"] != kv1["deferrals_total"] \
                or evicted != kv1["blocks_cached"]:
            fail(f"after the prefix release: pool {kv2}, before the flush "
                 f"{kv1}, before registration {kv0}")
        out["prefix"]["released_pages_evicted"] = evicted
        out["prefix"]["blocks_used_before_after"] = [kv0["blocks_used"],
                                                     kv2["blocks_used"]]
    # 2. Migration: 4 greedy streams and a sampled one ejected from A
    # after 8 tokens each, resumed on B, against B's uninterrupted runs.
    prompts = [rng.integers(0, vocab, MIGRATE_PROMPT).tolist()
               for _ in range(MIGRATE_REQUESTS)]
    fresh = concurrent(pb, [{"prompt": p, "maxNewTokens": MIGRATE_NEW}
                            for p in prompts])
    # Each stream names its tenant and runs as batch: the eject frames
    # must carry those keys, as the JAX engine's do.
    streams = [Stream(pa, {"prompt": p, "maxNewTokens": MIGRATE_NEW,
                           "tenant": f"fleet-{i}", "priority": "batch"})
               for i, p in enumerate(prompts)]
    wait_streamed(streams, MIGRATE_AFTER)
    t0 = time.perf_counter()
    code, ej = post_json(pa, "/v1/admin/eject", {})
    eject_ms = (time.perf_counter() - t0) * 1e3
    if code != 200 or ej.get("ejected") != MIGRATE_REQUESTS:
        fail(f"/v1/admin/eject: {code} {ej}")
    finals = [s.final() for s in streams]
    if any(f.get("status") != "migrate" for f in finals):
        fail(f"an ejected stream ended {finals}")
    carries = [(f["resume"].get("tenant"), f["resume"].get("priority"),
                f["resume"].get("preempted")) for f in finals]
    if carries != [(f"fleet-{i}", "batch", 0) for i in range(len(finals))]:
        fail(f"the eject frames carry the tenancy keys {carries}")
    resumed = [Stream(pb, {"resumeFrom": f["resume"]}) for f in finals]
    committed = [splice(a, b, w["tokens"], f"greedy stream {i}")
                 for i, (a, b, w) in enumerate(zip(streams, resumed,
                                                   fresh))]
    sampled_body = {"prompt": rng.integers(0, vocab, MIGRATE_PROMPT)
                    .tolist(), "maxNewTokens": MIGRATE_NEW,
                    "temperature": SAMPLED_TEMPERATURE,
                    "prngKey": SAMPLED_KEY}
    want_s = concurrent(pb, [sampled_body])[0]["tokens"]
    s_a = Stream(pa, sampled_body)
    wait_streamed([s_a], MIGRATE_AFTER)
    code, ej = post_json(pa, "/v1/admin/eject", {})
    resume_s = s_a.final().get("resume") or {}
    if code != 200 or ej.get("ejected") != 1:
        fail(f"/v1/admin/eject of the sampled stream: {code} {ej}")
    if resume_s.get("prngKey") != SAMPLED_KEY \
            or resume_s.get("temperature") != SAMPLED_TEMPERATURE:
        fail(f"the sampled resume state lost its key: {resume_s}")
    s_b = Stream(pb, {"resumeFrom": resume_s})
    committed.append(splice(s_a, s_b, want_s, "sampled stream"))
    out["migration"] = dict(
        streams=MIGRATE_REQUESTS, sampled=1, new_tokens=MIGRATE_NEW,
        committed=committed, eject_ms=eject_ms, tenancy_carries=carries,
        ttft_ms_resumed=[b.final()["ttftMs"] for b in resumed],
        ttft_ms_fresh=[r["ttftMs"] for r in fresh],
        spliced_equal_uninterrupted=True)
    # 3. Cancel a queued and a decoding request; /v1/result reads them.
    # The decoding one is the last admitted, so that it is still decoding
    # when the cancel lands (the others may finish by then).
    streams = [Stream(pa, {"prompt": rng.integers(0, vocab, 16).tolist(),
                           "maxNewTokens": CANCEL_NEW})
               for _ in range(NUM_SLOTS + 1)]
    wait_streamed(streams[:1], 1)
    rid0 = streams[0].lines[0]["requestId"]
    rid_q = rid0 + NUM_SLOTS             # ids follow the submit order
    rid_d = rid_q - 1
    deadline = time.time() + 60
    while True:                          # the other 8 admitted
        m = get_metrics(pa)
        if m["queued"] == 1 and m["slots_busy"] == NUM_SLOTS:
            break
        if time.time() > deadline:
            fail(f"the cancel phase never had one request queued: {m}")
        time.sleep(0.001)
    wait_streamed(streams[NUM_SLOTS - 1:NUM_SLOTS], 1)   # its first token
    pending = get_json(pa, f"/v1/result?requestId={rid_q}")
    queued = get_metrics(pa)["queued"]
    cancels = [post_json(pa, "/v1/cancel", {"requestId": r})
               for r in (rid_q, rid_d)]
    views = [get_json(pa, f"/v1/result?requestId={r}") for r in (rid_q,
                                                                  rid_d)]
    if pending != (200, {"status": "pending", "requestId": rid_q,
                         "tokensSoFar": 0}) or queued != 1:
        fail(f"the queued request: /v1/result {pending}, queued {queued}")
    if any(c != (200, {"status": "ok", "requestId": r, "cancelled": True})
           for c, r in zip(cancels, (rid_q, rid_d))):
        fail(f"/v1/cancel: {cancels}")
    if any(c != 200 or v.get("status") != "cancelled" for c, v in views) \
            or views[0][1]["tokens"] or not views[1][1]["tokens"]:
        fail(f"/v1/result after the cancels: {views}")
    for s in streams[:NUM_SLOTS - 1]:
        if s.final().get("status") != "ok":
            fail(f"a stream beside the cancels ended {s.final()}")
    if get_json(pa, "/v1/result?requestId=999999")[0] != 404:
        fail("/v1/result of an unknown id did not answer 404")
    kv = get_metrics(pa)["kv_cache"]
    if paged and kv["blocks_free"] + kv["blocks_cached"] != kv["blocks_total"]:
        fail(f"pages leaked after the cancels: {kv}")
    out["cancel"] = dict(queued_cancelled=views[0][1]["finishReason"],
                         decoding_cancelled_after=len(views[1][1]["tokens"]))
    # 4. The metrics ports against what the phase did.
    fam = serve.SERVING_FAMILIES
    sa, sb = scrape(mports[0], fam), scrape(mports[1], fam)
    want = {(0, "ktwe_serving_ejected_requests_total"): MIGRATE_REQUESTS + 1,
            (0, "ktwe_serving_resume_requests_total"): 0,
            (0, "ktwe_serving_prefix_hits_total"): NUM_SLOTS,
            (0, "ktwe_serving_prefixes_registered"): 0,
            (0, "ktwe_serving_requests_cancelled_total"): 2,
            (1, "ktwe_serving_ejected_requests_total"): 0,
            (1, "ktwe_serving_resume_requests_total"): MIGRATE_REQUESTS + 1,
            (1, "ktwe_serving_resume_committed_tokens_total"):
                sum(committed),
            # The migrated views metered their tokens but no request; the
            # resumes completed the 4 batch requests on B.
            (0, "ktwe_serving_tenant_tokens_batch_total"):
                sum(committed[:MIGRATE_REQUESTS]),
            (0, "ktwe_serving_tenant_requests_batch_total"): 0,
            (1, "ktwe_serving_tenant_requests_batch_total"):
                MIGRATE_REQUESTS}
    for (i, name), value in want.items():
        if (sa, sb)[i][name] != value:
            fail(f"metrics port {'AB'[i]}: {name} {(sa, sb)[i][name]}, "
                 f"want {value}")
    out["metrics_port"] = dict(families=len(fam),
                               a={k: sa[k] for k in fam if "resume" in k
                                  or "eject" in k},
                               b={k: sb[k] for k in fam if "resume" in k
                                  or "eject" in k})
    out["lifetime_a"] = get_metrics(pa)["lifetime"]
    out["lifetime_b"] = get_metrics(pb)["lifetime"]
    return out


# ---------------------------------------------------------------------------
# Phase 5b: the serving replica's observability
# ---------------------------------------------------------------------------


class OptimizerStub:
    """An HTTP stand-in for the optimizer service: it answers POST
    /v1/serving-telemetry {"status": "ok"} when the bearer token is right
    (401 otherwise) and keeps every push it got, with its token's
    verdict."""

    def __init__(self, token: str):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        self.pushes, self.bad_tokens = [], 0
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                ok = (self.path == "/v1/serving-telemetry" and
                      self.headers.get("Authorization")
                      == f"Bearer {token}")
                if ok:
                    stub.pushes.append(body)
                else:
                    stub.bad_tokens += 1
                out = json.dumps({"status": "ok"} if ok else
                                 {"status": "error"}).encode()
                self.send_response(200 if ok else 401)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(out)))
                self.end_headers()
                self.wfile.write(out)

            def log_message(self, *a):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)


def timed_flight_record(flight_mod) -> list:
    """Wrap FlightRecorder.record so each call's host seconds land in the
    returned list (the recorder's whole per-request cost: the tree, the
    phase windows and the span writes). Undo with untimed_flight_record."""
    took, record = [], flight_mod.FlightRecorder.record

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return record(self, *a, **kw)
        finally:
            took.append(time.perf_counter() - t0)
    timed.untimed = record
    flight_mod.FlightRecorder.record = timed
    return took


def obs_requests(vocab: int) -> list:
    """The serving cell's 9 greedy requests: 8 prompts of 128 tokens and
    one of 160, 48 new tokens each."""
    rng = np.random.default_rng(OBS_SEED)
    return [{"prompt": rng.integers(0, vocab, n).tolist(),
             "maxNewTokens": NEW_TOKENS}
            for n in [PROMPT_LEN] * N_REQUESTS + [LONG_PROMPT_LEN]]


def obs_traffic(port: int, auth: dict, bodies: list) -> list:
    """A warm-up request (the decode graph's capture), then `bodies` sent
    at once: their final views."""
    code, warm = post_json(port, "/v1/generate", {
        "prompt": bodies[0]["prompt"][:16], "maxNewTokens": 8,
        "timeoutSeconds": 300}, headers=auth)
    if code != 200 or warm.get("status") != "ok":
        fail(f"observability warm-up: {code} {warm}")
    out = [None] * len(bodies)

    def send(i):
        out[i] = post_json(port, "/v1/generate",
                           dict(bodies[i], timeoutSeconds=300),
                           headers=auth)
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(bodies))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    for code, r in out:
        if code != 200 or r.get("status") != "ok":
            fail(f"observability /v1/generate: {code} {r}")
    return [warm] + [r for _, r in out]


def span_tree(spans: list, trace_id: str, gates: list, what: str):
    """(root, {child name: span}) of a trace's one replica.generate root;
    a gate fails unless there is exactly one."""
    tree = [s for s in spans if s["traceId"] == trace_id]
    roots = [s for s in tree if s["name"] == "replica.generate"]
    if len(roots) != 1:
        gates.append(f"{what}: trace {trace_id} has {len(roots)} "
                     f"replica.generate roots")
        return None, {}
    kids = {s["name"]: s for s in tree
            if s["parentSpanId"] == roots[0]["spanId"]}
    return roots[0], kids


def run_observability(serve, kernels, card) -> dict:
    """The observability phase: three paged serve mains at the serve
    defaults (bf16, graphed), with the launch counters set to 0 just
    before they start and read after they exit. A (recorder, trace and
    telemetry on: --span-out, --trace-out, --slo-capture-threshold,
    --optimizer-url to a stub, --telemetry-interval 1, --tenants 2), B (the
    same, where A's ejected stream resumes) and C (none of those flags).
    A and C answer the serving cell's 9 greedy requests in turn; A also a
    request with an incoming traceparent, a stream ejected and resumed on B
    under one trace, and a budget 429. The gates are in the module
    notes."""
    from k8s_gpu_workload_enhancer_tpu_torch.observability import \
        flight as flight_mod
    gates, out = [], {}
    auth = {"Authorization": f"Bearer {OBS_TOKEN}"}
    tmp = tempfile.mkdtemp(prefix="ktwe-obs-")
    files = {k: os.path.join(tmp, f"{k}.ndjson")
             for k in ("spans_a", "trace_a", "spans_b", "trace_b")}
    base = ["--device", "cuda", "--port", "0", "--seed", "0",
            "--kv-block-len", str(KV_BLOCK_LEN), "--auth-token", OBS_TOKEN,
            "--tenant-budget", "probe=0"]
    mports = [free_port(), free_port()]
    stub = OptimizerStub(OBS_TOKEN)
    took = timed_flight_record(flight_mod)
    obs = ["--optimizer-url", stub.url, "--telemetry-interval", "1",
           "--tenants", str(OBS_TENANTS), "--slo-capture-threshold",
           str(OBS_SLO_S)]
    buf = io.StringIO()
    kernels.reset_launches()
    try:
        with contextlib.redirect_stdout(buf):
            c = ServeMain(serve, base + ["--metrics-port", str(mports[1])])
            a = ServeMain(serve, base + obs + [
                "--span-out", files["spans_a"], "--trace-out",
                files["trace_a"], "--metrics-port", str(mports[0])])
            b = ServeMain(serve, base + obs + [
                "--span-out", files["spans_b"], "--trace-out",
                files["trace_b"]])
            try:
                out = obs_phase(a.port, b.port, c.port, mports, auth, files,
                                serve, gates)
                # The telemetry thread pushes once a second: wait for one
                # with tokens to report.
                deadline = time.time() + 30
                while not stub.pushes and time.time() < deadline:
                    time.sleep(0.1)
            finally:
                a.close()
                b.close()
                c.close()
    finally:
        flight_mod.FlightRecorder.record = \
            flight_mod.FlightRecorder.record.untimed
        stub.close()
    launches = dict(kernels.launches)
    life = {k: sum(out["lifetime"][m][k] for m in "abc")
            for k in ("prefill_chunks", "decode_steps")}
    want = expected_launches(SERVE_DIMS["n_layers"], life, paged=True)
    if launches != want:
        gates.append(f"observability launches {launches}, its chunks and "
                     f"steps need {want}")
    bucket = (f"d{SERVE_DIMS['d_model']}-L{SERVE_DIMS['n_layers']}"
              f"-ff{SERVE_DIMS['d_ff']}-V{SERVE_DIMS['vocab_size']}|bf16")
    good = [p for p in stub.pushes if p.get("bucket") == bucket
            and p.get("tenants") == OBS_TENANTS
            and p.get("slots") == NUM_SLOTS and p.get("tokens_per_s", 0) > 0]
    if not good or stub.bad_tokens:
        gates.append(f"telemetry: {len(stub.pushes)} pushes ({len(good)} "
                     f"with bucket {bucket}, tenants {OBS_TENANTS}, slots "
                     f"{NUM_SLOTS}), {stub.bad_tokens} with a wrong token: "
                     f"{stub.pushes[:2]}")
    views = out["terminal_views"]
    bytes_ = {k: os.path.getsize(v) if os.path.exists(v) else 0
              for k, v in files.items()}
    rotated = [f for f in os.listdir(tmp) if ".ndjson." in f]
    trace_bytes = bytes_["trace_a"] + bytes_["trace_b"] + sum(
        os.path.getsize(os.path.join(tmp, f)) for f in rotated
        if f.startswith("trace_"))
    shutil.rmtree(tmp, ignore_errors=True)
    record_ms = sorted(t * 1e3 for t in took)
    out.update(
        card=card, launches=launches,
        telemetry=dict(pushes=len(stub.pushes), matching=len(good),
                       bad_tokens=stub.bad_tokens,
                       first=good[0] if good else None),
        flight_record_host_ms=dict(
            calls=len(record_ms),
            p50=record_ms[len(record_ms) // 2] if record_ms else None,
            mean=(sum(record_ms) / len(record_ms)) if record_ms else None,
            max=record_ms[-1] if record_ms else None),
        span_bytes_per_request=(bytes_["spans_a"] + bytes_["spans_b"])
        / max(1, views),
        trace_bytes_per_request=trace_bytes / max(1, views + 1),
        gates_failed=gates)
    return out


def obs_phase(pa: int, pb: int, pc: int, mports, auth: dict, files: dict,
              serve, gates: list) -> dict:
    vocab = SERVE_DIMS["vocab_size"]
    bodies = obs_requests(vocab)
    # C (recorder off) first, then A: the same 9 requests in turn.
    views_c = obs_traffic(pc, auth, bodies)
    views_a = obs_traffic(pa, auth, bodies)
    equal = sum(x["tokens"] == y["tokens"]
                for x, y in zip(views_a[1:], views_c[1:]))
    if equal != len(bodies):
        gates.append(f"recorder on against off: {equal} of {len(bodies)} "
                     f"greedy streams equal")
    if any("traceId" in v for v in views_c):
        gates.append("a recorder-off view carries a traceId")
    # An incoming traceparent is adopted.
    tp = OBS_TRACEPARENT
    code, tview = post_json(pa, "/v1/generate", dict(
        bodies[0], timeoutSeconds=300), headers=dict(auth, traceparent=tp))
    if code != 200 or tview.get("traceId") != tp.split("-")[1] \
            or tview.get("traceparent") != tp:
        gates.append(f"the traceparent request: {code} {tview}")
    # A stream ejected from A and resumed on B under one trace.
    tp2 = OBS_TRACEPARENT_MIGRATE
    ej_body = {"prompt": bodies[1]["prompt"], "maxNewTokens": MIGRATE_NEW}
    s_a = Stream(pa, ej_body, headers=dict(auth, traceparent=tp2))
    wait_streamed([s_a], MIGRATE_AFTER)
    code, ej = post_json(pa, "/v1/admin/eject", {}, headers=auth)
    fa = s_a.final()
    if code != 200 or ej.get("ejected") != 1 or fa.get("status") != \
            "migrate":
        fail(f"observability eject: {code} {ej}, the stream ended {fa}")
    s_b = Stream(pb, {"resumeFrom": fa["resume"]},
                 headers=dict(auth, traceparent=tp2))
    fb = s_b.final()
    code, want = post_json(pc, "/v1/generate", dict(
        ej_body, timeoutSeconds=300), headers=auth)
    if code != 200:
        fail(f"the uninterrupted stream on C: {code} {want}")
    spliced = s_a.tokens() + s_b.tokens()
    # A budget 429, traced as a rejected arrival.
    code, rej = post_json(pa, "/v1/generate", dict(bodies[0], maxNewTokens=4),
                          headers=dict(auth, **{"x-ktwe-tenant": "probe"}))
    if code != 429 or rej.get("reason") != "budget-exhausted":
        gates.append(f"the budget probe answered {code} {rej}")
    finals_a = views_a + [tview, fa]
    finals_b = [fb]
    # The span trees.
    spans_a = read_ndjson(files["spans_a"])
    spans_b = read_ndjson(files["spans_b"])
    chunk_events = 0
    for views, spans, what in ((finals_a, spans_a, "A"),
                               (finals_b, spans_b, "B")):
        for v in views:
            root, kids = span_tree(spans, v.get("traceId"), gates, what)
            if root is None:
                continue
            missing = {"admission", "queue_wait", "prefill", "decode"} - \
                set(kids)
            if missing:
                gates.append(f"{what}: trace {v['traceId']} lacks {missing}")
                continue
            chunk_events += sum(e["name"] == "prefill_chunk"
                                for e in kids["prefill"]["events"])
    for v, body in zip(views_a[1:], bodies):
        root, kids = span_tree(spans_a, v["traceId"], gates, "A")
        n = sum(e["name"] == "prefill_chunk"
                for e in kids.get("prefill", {}).get("events", []))
        if n != -(-len(body["prompt"]) // PREFILL_LEN):
            gates.append(f"A: {n} prefill_chunk events for a "
                         f"{len(body['prompt'])}-token prompt")
    ma, mb, mc = (get_metrics(p, auth) for p in (pa, pb, pc))
    life = {"a": ma["lifetime"], "b": mb["lifetime"], "c": mc["lifetime"]}
    if chunk_events != ma["lifetime"]["prefill_chunks"] + \
            mb["lifetime"]["prefill_chunks"]:
        gates.append(f"{chunk_events} prefill_chunk events against "
                     f"{ma['lifetime']['prefill_chunks']} + "
                     f"{mb['lifetime']['prefill_chunks']} prefill chunks")
    ra, ka = span_tree(spans_a, tp2.split("-")[1], gates, "A eject")
    rb, kb = span_tree(spans_b, tp2.split("-")[1], gates, "B resume")
    if "eject" not in ka or "resume" not in kb or fb.get("traceId") != \
            tp2.split("-")[1] or (rb or {}).get("attributes", {}).get(
                "resume.committed") != len(fa["resume"]["committed"]):
        gates.append(f"the migration's marks: A {sorted(ka)}, B "
                     f"{sorted(kb)}, resumed view {fb.get('traceId')}")
    root_tp, _ = span_tree(spans_a, tp.split("-")[1], gates, "traceparent")
    if root_tp is not None and root_tp["parentSpanId"] != tp.split("-")[2]:
        gates.append(f"the traceparent root's parent {root_tp}")
    # Trace records: one a terminal view, one rejected.
    recs_a = read_ndjson(files["trace_a"])
    recs_b = read_ndjson(files["trace_b"])
    statuses = sorted(r["status"] for r in recs_a)
    want_status = sorted(["ok"] * (len(finals_a) - 1) + ["migrate",
                                                         "rejected"])
    if statuses != want_status or [r["status"] for r in recs_b] != ["ok"]:
        gates.append(f"trace records A {statuses}, B "
                     f"{[r['status'] for r in recs_b]}; want A "
                     f"{want_status}, B ['ok']")
    # The admin routes.
    code, st = post_json(pa, "/v1/admin/trace", {"action": "rotate"},
                         headers=auth)
    rotated = [f for f in os.listdir(os.path.dirname(files["trace_a"]))
               if f.startswith("trace_a.ndjson.")]
    if code != 200 or st.get("records") != len(recs_a) \
            or os.path.exists(files["trace_a"]) or len(rotated) != 1:
        gates.append(f"/v1/admin/trace rotate: {code} {st} {rotated}")
    code, sp = post_json(pa, "/v1/admin/spans", {"action": "status"},
                         headers=auth)
    if code != 200 or sp.get("records") != len(spans_a) or not sp["spans"]:
        gates.append(f"/v1/admin/spans: {code} {sp}, {len(spans_a)} spans")
    code, slow = get_json(pa, "/v1/admin/slow-requests", auth)
    if code != 200 or not slow.get("slow"):
        gates.append(f"/v1/admin/slow-requests: {code} "
                     f"{str(slow)[:200]}")
    code_off, slow_off = get_json(pc, "/v1/admin/slow-requests", auth)
    if code_off != 400:
        gates.append(f"recorder off: /v1/admin/slow-requests {code_off}")
    # The families: all 98 (since the serving mesh), the 19 of the
    # observability slice among them.
    fam = serve.SERVING_FAMILIES
    series = scrape(mports[0], fam)
    series_off = scrape(mports[1], fam)
    new = [k for k in fam if "phase_seconds" in k or "_span_" in k
           or "slow_requests" in k or "trace_records" in k]
    if len(fam) != 98 or len(new) != 19 or \
            series["ktwe_serving_span_records_total"] != len(spans_a) or \
            series["ktwe_serving_trace_records_total"] != len(recs_a) or \
            series["ktwe_serving_phase_seconds_prefill_p50"] <= 0 or \
            any(series_off[k] for k in new):
        gates.append(f"families: {len(fam)} served, {len(new)} new; "
                     f"{ {k: series[k] for k in new} }, off "
                     f"{ {k: series_off[k] for k in new if series_off[k]} }")
    captures = [m["hotpath"]["graphs_captured"] for m in (ma, mb, mc)]
    if captures != [1, 1, 1]:
        gates.append(f"decode graph captures A, B, C: {captures}")

    def per_token(m):
        hp, tokens = m["hotpath"], max(1, m["lifetime"]["tokens"])
        return dict(ms_per_token_p50=m["token_lat_p50_ms"],
                    commit_s_per_token=hp["commit_s_total"] / tokens,
                    commit_overlapped_share=(
                        hp["commit_overlapped_s_total"] / hp["commit_s_total"]
                        if hp["commit_s_total"] else 0.0),
                    tokens=m["lifetime"]["tokens"])
    return dict(
        requests=len(bodies), new_tokens=NEW_TOKENS,
        recorder_on=per_token(ma), recorder_off=per_token(mc),
        greedy_equal=[equal, len(bodies)],
        resumed_equal_uninterrupted=spliced == want["tokens"],
        resumed_tokens=[len(fa["resume"]["committed"]), len(spliced)],
        terminal_views=len(finals_a) + len(finals_b),
        spans=[len(spans_a), len(spans_b)],
        trace_records=[len(recs_a), len(recs_b)],
        prefill_chunk_events=chunk_events,
        slow_captured=len(slow.get("slow", [])),
        phase_seconds={k.replace("ktwe_serving_phase_seconds_", ""):
                       series[k] for k in new if "phase_seconds" in k},
        families=len(fam), captures=captures, lifetime=life)


def read_ndjson(path: str) -> list:
    with open(path, "r", encoding="utf-8") as f:
        return [json.loads(x) for x in f if x.strip()]


# ---------------------------------------------------------------------------
# Phase 5c: chunked prefill, the disaggregated roles and the drain grace
# ---------------------------------------------------------------------------


def storm_requests(vocab: int):
    """The storm of the JAX package's chunked_prefill_storm at the serve
    defaults: prompt lengths, prompts and arrival marks on the work
    clock, drawn in its order from its seed."""
    rng = np.random.default_rng(STORM_SEED)
    short = max(2, PREFILL_LEN // 16)
    lens = [short] * 3 + [PREFILL_LEN] + [short] * 3 + [PREFILL_LEN // 2]
    prompts = [[int(rng.integers(1, vocab - 1))
                for _ in range(lens[i % len(lens)])]
               for i in range(STORM_REQUESTS)]
    # Default-config work a request: a padded prefill chunk, plus its
    # decode steps over about half the slots; marks at 0.8 of capacity.
    per_req_work = PREFILL_LEN + STORM_NEW * 2.0 / NUM_SLOTS
    arrivals = np.cumsum(rng.exponential(per_req_work / 0.8,
                                         size=STORM_REQUESTS))
    return lens, prompts, arrivals


def storm_run(eng, prompts, arrivals, short_len: int) -> dict:
    """The storm on `eng`: a request is submitted once the work clock
    (decode steps + prefill chunks x prefill_len) reaches its mark, or at
    once on an idle engine; its TTFT in work tokens is the work serialized
    between its submit and its first token's commit. Returns the
    requests, the short class's TTFT (work tokens and wall ms) and the
    length of every chunk dispatched."""
    from k8s_gpu_workload_enhancer_tpu_torch.utils.stats import percentile
    lengths = []
    dispatch = eng._dispatch_chunk

    def recorded():
        inflight = dispatch()
        lengths.append(inflight.n)
        return inflight
    eng._dispatch_chunk = recorded

    def work_clock():
        return (eng._decode_steps_total
                + eng._prefill_chunks_total * eng.prefill_len)
    life0 = dict(eng.metrics_snapshot()["lifetime"])
    # The marks count from the clock at the storm's start (a warm-up ran
    # before it).
    arrivals = arrivals + work_clock()
    submitted, ttft_work, rids, i = {}, {}, [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while i < len(prompts) or eng.active:
        clock = work_clock()
        due = clock if eng.active else arrivals[i]
        while i < len(prompts) and arrivals[i] <= due:
            rids.append(eng.submit(prompts[i], STORM_NEW))
            submitted[rids[-1]] = clock
            i += 1
        eng.step()
        clock = work_clock()
        for rid in rids:
            if rid not in ttft_work and eng.result(rid).tokens:
                ttft_work[rid] = clock - submitted[rid]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del eng._dispatch_chunk
    reqs = [eng.result(r) for r in rids]
    if any(r.finish_reason != "length" for r in reqs):
        fail(f"storm: a request ended {[r.finish_reason for r in reqs]}")
    short = [(ttft_work[r.req_id], (r.first_token_at - r.submitted_at) * 1e3)
             for r in reqs if len(r.prompt) <= short_len]
    work = sorted(w for w, _ in short)
    ms = sorted(m for _, m in short)
    life = {k: v - life0[k]
            for k, v in eng.metrics_snapshot()["lifetime"].items()}
    if sum(lengths) != life["decode_steps"]:
        fail(f"storm: chunks of {lengths} steps, decode_steps "
             f"{life['decode_steps']}")
    return dict(reqs=reqs, lengths=lengths, wall_s=wall,
                short_ttft_work_p50=percentile(work, 50),
                short_ttft_work_p99=percentile(work, 99),
                short_ttft_ms_p50=percentile(ms, 50),
                short_ttft_ms_p99=percentile(ms, 99),
                tokens_per_s=sum(len(r.tokens) for r in reqs) / wall,
                prefill_chunks=life["prefill_chunks"],
                decode_steps=life["decode_steps"])


def storm_warm_up(eng) -> None:
    """NUM_SLOTS + 1 short requests at once before the storm: a backlog,
    so a graphed engine captures its decode graphs (the chunked one its
    quantum's too) before any storm request's TTFT runs."""
    rids = [eng.submit([1 + i] * 8, 4) for i in range(NUM_SLOTS + 1)]
    eng.run()
    for r in rids:
        eng.release(r)


def run_chunked_storm(dev, mods, cfg, params, gates: list, life: dict,
                      burst: bool = False, f32: bool = False) -> dict:
    """The storm on the dense and the paged engine (pages of 16), each at
    prefill_chunk_tokens 0 and 32, graphed and pipelined (watchdog armed)
    and again eager and serialized, each engine warmed up first
    (storm_warm_up). `burst`: every request arrives at once, so a backlog
    lasts until the queue drains and the chunked engine decodes quanta.
    Gates: graphed == eager bit for bit (tokens and logprobs) at each
    slice size; 2 captures on a chunked graphed engine, 1 on a plain one;
    no page leaked; in f32 (`f32`: the weights cast, not counted) the
    chunked engines' tokens equal the plain ones'. In bf16 the chunked
    transcripts are counted against the plain ones (a 32-row prefill
    GEMM may round otherwise than a 128-row one: gemm_row_invariance).
    Failed gates go to `gates`, the engines' lifetime totals by kind
    (paged or not) to `life`, for the launch count."""
    serving = mods[7]
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
        params = cast_params(params, torch.float32)
    lens, prompts, arrivals = storm_requests(cfg.vocab_size)
    if burst:
        arrivals = np.zeros_like(arrivals)
    what = ("burst" if burst else "storm") + (" f32" if f32 else "")
    out = {}
    for paged in (False, True):
        kind = "paged" if paged else "dense"
        runs = {}
        for chunk in (0, STORM_CHUNK_TOKENS):
            for graphed in (True, False):
                kw = dict(prefill_chunk_tokens=chunk)
                if paged:
                    kw["kv_block_len"] = KV_BLOCK_LEN
                if graphed:
                    kw["watchdog_timeout"] = WATCHDOG_S
                else:
                    kw.update(cuda_graph=False, overlap_commit=False)
                eng = new_engine(serving, params, cfg, dev, max_queue=256,
                                 **kw)
                storm_warm_up(eng)
                rep = storm_run(eng, prompts, arrivals, lens[0])
                m = eng.metrics()
                if not f32:
                    for k in life[paged]:
                        life[paged][k] += m["lifetime"][k]
                name = (f"{'chunked' if chunk else 'plain'}_"
                        f"{'graphed' if graphed else 'eager'}")
                if paged:
                    kv = m["kv_cache"]
                    if kv["blocks_free"] + kv["blocks_cached"] \
                            != kv["blocks_total"]:
                        gates.append(f"{what} {kind} {name}: pages leaked "
                                     f"{kv}")
                q = eng._decode_quantum
                rep.update(quantum_chunks=(rep["lengths"].count(q)
                                           if chunk else 0),
                           chunks=len(rep["lengths"]))
                if graphed:
                    hp = hotpath_report(eng)
                    want = 2 if chunk else 1
                    if hp["graphs_captured"] != want or hp["watchdog_trips"] \
                            or (burst and chunk and not rep["quantum_chunks"]):
                        gates.append(f"{what} {kind} {name}: "
                                     f"{hp['graphs_captured']} captures "
                                     f"(want {want}), {hp['watchdog_trips']} "
                                     f"watchdog trips")
                    rep["capture_ms"] = eng._graph.capture_ms
                    if eng._quantum_graph is not None:
                        rep["quantum_capture_ms"] = \
                            eng._quantum_graph.capture_ms
                    rep["graphs_captured"] = hp["graphs_captured"]
                del rep["lengths"]
                runs[name] = rep
                del eng
        transcripts = {name: rep.pop("reqs") for name, rep in runs.items()}
        for name, rep in runs.items():
            reqs = transcripts[name]
            ref = transcripts[name.replace("graphed", "eager")]
            plain = transcripts["plain_eager"]
            differ = [i for i, (g, w) in enumerate(zip(reqs, ref))
                      if (g.tokens, g.logprobs) != (w.tokens, w.logprobs)]
            if differ:
                gates.append(f"{what} {kind} {name}: {len(differ)} requests "
                             f"differ from the eager engine's")
            rep["requests_equal_plain"] = sum(
                (g.tokens, g.logprobs) == (w.tokens, w.logprobs)
                for g, w in zip(reqs, plain))
            rep["tokens_equal_plain"] = sum(
                g.tokens == w.tokens for g, w in zip(reqs, plain))
            rep["max_logprob_diff_plain"] = max(
                abs(a - b) for g, w in zip(reqs, plain)
                for a, b in zip(g.logprobs, w.logprobs))
            diverged = [dict(request=i, prompt=len(g.prompt),
                             at=divergence(g.tokens, w.tokens))
                        for i, (g, w) in enumerate(zip(reqs, plain))
                        if g.tokens != w.tokens]
            rep["tokens_diverged_plain"] = diverged
            if f32 and diverged:
                gates.append(f"{what} {kind} {name}: tokens left the plain "
                             f"engine's: {diverged}")
        runs["ttft_p99_ratio_work"] = (
            runs["chunked_graphed"]["short_ttft_work_p99"]
            / max(runs["plain_graphed"]["short_ttft_work_p99"], 1e-9))
        runs["ttft_p99_ratio_ms"] = (
            runs["chunked_graphed"]["short_ttft_ms_p99"]
            / max(runs["plain_graphed"]["short_ttft_ms_p99"], 1e-9))
        out[kind] = runs
        torch.cuda.empty_cache()
    return dict(prompt_lens=lens, requests=STORM_REQUESTS, new=STORM_NEW,
                chunk_tokens=STORM_CHUNK_TOKENS, **out)


def gemm_row_invariance(dev, tf, params) -> dict:
    """Whether a prefill GEMM's rows depend on the chunk's row count: the
    first 32 rows of a (128, K) @ W product against the (32, K) @ W
    product of the same rows, for layer 0's wq, w_gate (K = d_model) and
    w_down (K = d_ff), in bf16 and f32 (cuBLAS picks a kernel, and with it
    a summation order, by the shape). Elements that differ and the
    largest difference."""
    gen = torch.Generator(device=dev).manual_seed(5)
    lp = tf.layer_params(params, 0)
    out = {}
    for name in ("wq", "w_gate", "w_down"):
        w2 = lp[name].reshape(lp[name].shape[0], -1)
        for dt in (torch.bfloat16, torch.float32):
            w = w2.to(dt)
            x = torch.randn((PREFILL_LEN, w.shape[0]), generator=gen,
                            device=dev).to(dt)
            whole, part = (x @ w)[:STORM_CHUNK_TOKENS], \
                x[:STORM_CHUNK_TOKENS] @ w
            diff = (whole.float() - part.float()).abs()
            out[f"{name}_{str(dt).split('.')[-1]}"] = dict(
                shape=[list(x.shape), list(w.shape)],
                elements_differing=int((diff > 0).sum()),
                max_abs_diff=float(diff.max()))
    return out


class RoleService:
    """A ServeService with `role` on an in-process engine, behind an HTTP
    server (the serve main's routes): the f32 replicas of the disagg
    phase, whose weights the serve main (bf16 on the card) cannot take."""

    def __init__(self, serve, engine, role: str):
        from http.server import ThreadingHTTPServer
        self.svc = serve.ServeService(engine, role=role)
        self.server = ThreadingHTTPServer(("127.0.0.1", 0),
                                          serve.make_handler(self.svc))
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.port = self.server.server_address[1]

    def close(self):
        self.svc.stop()
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(60)


def disagg_bodies(vocab: int) -> list:
    rng = np.random.default_rng(DISAGG_KEY)
    bodies = []
    for i in range(DISAGG_STREAMS):
        body = {"prompt": rng.integers(0, vocab, DISAGG_PROMPT).tolist(),
                "maxNewTokens": DISAGG_NEW}
        if i >= DISAGG_STREAMS // 2:
            body.update(temperature=SAMPLED_T, prngKey=[DISAGG_KEY, i])
        bodies.append(body)
    return bodies


def handoffs(pf_port: int, dec_port: int, mixed_port: int, bodies,
             what: str, gates: list, exact: bool) -> dict:
    """Every body streamed to the prefill replica, which must end it after
    token #1 with a reason "handoff" migrate frame; a thread a stream posts
    the resume to the decode replica as soon as the frame lands (the
    router's splice). The spliced stream (offsets contiguous from 0) is
    held to the mixed replica's uninterrupted reply: `exact` gates the
    equality, else the equal ones are counted and the rest printed."""
    want = concurrent(mixed_port, bodies)
    # Warm-ups, not timed: a one-token request finishes on the prefill
    # replica without a handoff; a fresh request on the decode replica
    # captures its decode graph.
    for port, n in ((pf_port, 1), (dec_port, 16)):
        warm = post_json(port, "/v1/generate", {"prompt": [5] * 8,
                                                "maxNewTokens": n})[1]
        if warm.get("finishReason") != "length":
            gates.append(f"{what}: a warm-up request ended {warm}")
    pf, threads = [], []
    resumed, posted = [None] * len(bodies), [None] * len(bodies)

    def hop(i):
        # The router's move: post the resume as soon as the frame is read
        # (the connection closes after it).
        a, deadline = pf[i], time.time() + 300
        while not (a.lines and "status" in a.lines[-1]):
            if a.done.is_set() or time.time() > deadline:
                return
            time.sleep(0.0002)
        final = a.lines[-1]
        if final.get("status") == "migrate":
            posted[i] = time.perf_counter()
            resumed[i] = Stream(dec_port, {"resumeFrom": final["resume"]})
    for i, body in enumerate(bodies):
        pf.append(Stream(pf_port, body))
        threads.append(threading.Thread(target=hop, args=(i,)))
        threads[-1].start()
    for th in threads:
        th.join(600)
    equal, diverged, ttft, hop_ms, post_ms, dec_ttft = 0, [], [], [], [], []
    for i, (a, b) in enumerate(zip(pf, resumed)):
        fa = a.final()
        st = fa.get("resume") or {}
        if fa.get("status") != "migrate" or st.get("reason") != "handoff" \
                or b is None or a.tokens() != st.get("committed") \
                or len(st["committed"]) != 1:
            gates.append(f"{what} stream {i}: the prefill replica ended "
                         f"{fa}")
            continue
        fb = b.final()
        seen, toks = 0, []
        for x in a.lines[:-1] + b.lines[:-1]:
            if x["offset"] != seen:
                gates.append(f"{what} stream {i}: offset {x['offset']} where "
                             f"{seen} was due")
            toks += x["tokens"]
            seen += len(x["tokens"])
        if fb.get("status") != "ok" or fb.get("committedOffset") != 1:
            gates.append(f"{what} stream {i}: the decode replica ended {fb}")
        ttft.append(fa["ttftMs"])
        hop_ms.append((b.times[0] - a.times[-1]) * 1e3)
        post_ms.append((posted[i] - a.times[-1]) * 1e3)
        dec_ttft.append(fb.get("ttftMs"))
        j = divergence(toks, want[i]["tokens"])
        if j is None:
            equal += 1
        else:
            diverged.append(dict(stream=i, at=j, sampled="prngKey" in
                                 bodies[i]))
            if exact:
                gates.append(f"{what} stream {i}: the spliced stream left "
                             f"the uninterrupted one at token {j}")
    return dict(streams=len(bodies), equal_uninterrupted=equal,
                diverged=diverged, prefill_ttft_ms=ttft, hop_ms=hop_ms,
                hop_ms_p50=float(np.median(hop_ms)) if hop_ms else None,
                frame_to_post_ms=post_ms, decode_side_ttft_ms=dec_ttft)


def check_roles(pf: dict, dec: dict, what: str, gates: list) -> None:
    """The prefill replica's /v1/metrics: role prefill, no decode step, no
    graph, a handoff a stream; the decode replica's role decode."""
    got = (pf["role"], pf["lifetime"]["decode_steps"],
           pf["hotpath"]["graphs_captured"],
           pf["migration"]["handoffs_total"], dec["role"])
    if got != ("prefill", 0, 0, DISAGG_STREAMS, "decode"):
        gates.append(f"{what}: (prefill role, decode steps, captures, "
                     f"handoffs, decode role) = {got}")


def run_handoffs(mods, cfg, gates: list) -> tuple:
    """The bf16 serve mains (paged, pages of 16): a --disagg prefill and a
    --disagg decode replica, each with a --metrics-port, and a mixed one
    for the uninterrupted streams. Returns the report and the mains'
    lifetime totals (launches are counted by the caller)."""
    serve = mods[8]
    base = ["--device", "cuda", "--port", "0", "--seed", "0",
            "--kv-block-len", str(KV_BLOCK_LEN)]
    mports = [free_port(), free_port()]
    bodies = disagg_bodies(cfg.vocab_size)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mains = [ServeMain(serve, base + ["--disagg", role, "--metrics-port",
                                          str(mp)])
                 for role, mp in (("prefill", mports[0]),
                                  ("decode", mports[1]))]
        mains.append(ServeMain(serve, base))
        try:
            rep = handoffs(*(m.port for m in mains), bodies, "disagg bf16",
                           gates, exact=False)
            ms = [get_json(m.port, "/v1/metrics")[1]["metrics"]
                  for m in mains]
            series = scrape(mports[0], serve.SERVING_FAMILIES)
        finally:
            for m in mains:
                m.close()
    check_roles(ms[0], ms[1], "disagg bf16", gates)
    if series["ktwe_serving_handoffs_total"] != DISAGG_STREAMS:
        gates.append(f"disagg bf16: ktwe_serving_handoffs_total "
                     f"{series['ktwe_serving_handoffs_total']}")
    life = {k: sum(m["lifetime"][k] for m in ms)
            for k in ("prefill_chunks", "decode_steps")}
    rep.update(metrics_port_handoffs_total=series[
        "ktwe_serving_handoffs_total"],
        roles=[m["role"] for m in ms],
        prefill_decode_steps=ms[0]["lifetime"]["decode_steps"],
        prefill_graphs_captured=ms[0]["hotpath"]["graphs_captured"])
    return rep, life


def run_handoffs_f32(dev, mods, cfg, params, gates: list) -> dict:
    """The f32 gate (not counted): the same streams through in-process
    services on the weights cast to f32 (graphed paged engines, pages of
    16), where every spliced stream must equal the mixed replica's."""
    serving, serve = mods[7], mods[8]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    reps = [RoleService(serve, new_engine(
        serving, p32, cfg32, dev, kv_block_len=KV_BLOCK_LEN,
        handoff_first_token=role == "prefill"), role)
        for role in ("prefill", "decode", "mixed")]
    try:
        rep = handoffs(*(r.port for r in reps),
                       disagg_bodies(cfg.vocab_size), "disagg f32", gates,
                       exact=True)
        ms = [r.svc.metrics({})["metrics"] for r in reps]
    finally:
        for r in reps:
            r.close()
    check_roles(ms[0], ms[1], "disagg f32", gates)
    del reps, p32
    torch.cuda.empty_cache()
    return rep


def run_drain_grace(gates: list) -> dict:
    """A serve main in its own process (the card, dense, one decode step a
    chunk, max_seq 8192) with --drain-timeout 30 --drain-eject-grace 2: a
    long stream, then SIGTERM. Its migrate frame must arrive within
    GRACE_S + GRACE_SLACK_S of the signal, and the process exit 0."""
    argv = [sys.executable, "-m",
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.serve", "--device",
            "cuda", "--port", "0", "--max-seq", str(GRACE_MAX_SEQ),
            "--decode-chunk", "1", "--drain-timeout",
            str(GRACE_DRAIN_TIMEOUT), "--drain-eject-grace", str(GRACE_S)]
    proc = subprocess.Popen(
        argv, cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONUNBUFFERED="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, up = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if "up on :" in line:
                up.set()
        up.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        if not up.wait(600) or proc.poll() is not None:
            fail(f"drain grace: the serve main did not come up: "
                 f"{''.join(lines)[-2000:]}")
        port = int(next(x for x in lines if "up on :" in x)
                   .split("up on :")[1].split()[0])
        s = Stream(port, {"prompt": list(range(1, 17)),
                          "maxNewTokens": GRACE_NEW})
        wait_streamed([s], 1)
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        final = s.final()
        waited = s.times[-1] - t0
        rc = proc.wait(timeout=GRACE_DRAIN_TIMEOUT + 60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(10)
    committed = len((final.get("resume") or {}).get("committed", []))
    if final.get("status") != "migrate" \
            or final["resume"].get("reason") != "eject" \
            or not 0 < committed < GRACE_NEW:
        gates.append(f"drain grace: the stream ended {final.get('status')} "
                     f"with {committed} committed tokens")
    if not waited <= GRACE_S + GRACE_SLACK_S:
        gates.append(f"drain grace: the migrate frame came {waited:.3f} s "
                     f"after SIGTERM, bound {GRACE_S + GRACE_SLACK_S}")
    if rc != 0 or not any("drain grace expired" in x for x in lines):
        gates.append(f"drain grace: exit {rc}: {''.join(lines)[-2000:]}")
    return dict(grace_s=GRACE_S, drain_timeout_s=GRACE_DRAIN_TIMEOUT,
                migrate_frame_s_after_sigterm=waited,
                committed_at_eject=committed, exit_code=rc)


def run_disagg(dev, mods, cfg, params) -> dict:
    """The disagg phase, with the launch counters set to 0 just before it
    and read after the bf16 handoffs: the chunked-prefill storm and its
    burst, the bf16 handoffs between serve mains; then, not counted, the
    burst and the handoffs in f32, the prefill GEMMs' row invariance and
    the drain grace (another process). Every gate is checked after the
    whole phase ran, so a failing run still prints its numbers."""
    kernels = mods[0]
    gates = []
    life = {paged: {"prefill_chunks": 0, "decode_steps": 0}
            for paged in (False, True)}
    kernels.reset_launches()
    storm = run_chunked_storm(dev, mods, cfg, params, gates, life)
    burst = run_chunked_storm(dev, mods, cfg, params, gates, life, True)
    bf16, life_serve = run_handoffs(mods, cfg, gates)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    for k, v in life_serve.items():
        life[True][k] += v
    want = expected_launches(cfg.n_layers, life[True], paged=True)
    for k, v in expected_launches(cfg.n_layers, life[False]).items():
        want[k] += v
    if launches != want:
        gates.append(f"disagg launches {launches}, its chunks and steps "
                     f"need {want}")
    burst32 = run_chunked_storm(dev, mods, cfg, params, gates, life, True,
                                True)
    f32 = run_handoffs_f32(dev, mods, cfg, params, gates)
    gemm = gemm_row_invariance(dev, mods[5], params)
    grace = run_drain_grace(gates)
    summary = {}
    for kind, r in (("dense", storm["dense"]), ("paged", storm["paged"]),
                    ("dense_burst", burst["dense"]),
                    ("paged_burst", burst["paged"])):
        summary[kind] = dict(
            short_ttft_ms_p50={k: r[f"{k}_graphed"]["short_ttft_ms_p50"]
                               for k in ("chunked", "plain")},
            short_ttft_ms_p99={k: r[f"{k}_graphed"]["short_ttft_ms_p99"]
                               for k in ("chunked", "plain")},
            short_ttft_work_p50={k: r[f"{k}_graphed"]["short_ttft_work_p50"]
                                 for k in ("chunked", "plain")},
            short_ttft_work_p99={k: r[f"{k}_graphed"]["short_ttft_work_p99"]
                                 for k in ("chunked", "plain")},
            ttft_p99_ratio_work=r["ttft_p99_ratio_work"],
            ttft_p99_ratio_ms=r["ttft_p99_ratio_ms"],
            quantum_chunks=r["chunked_graphed"]["quantum_chunks"],
            chunks={k: r[f"{k}_graphed"]["chunks"]
                    for k in ("chunked", "plain")},
            prefill_chunks={k: r[f"{k}_graphed"]["prefill_chunks"]
                            for k in ("chunked", "plain")},
            tokens_per_s={k: r[f"{k}_graphed"]["tokens_per_s"]
                          for k in ("chunked", "plain")},
            quantum_capture_ms=r["chunked_graphed"].get(
                "quantum_capture_ms"),
            chunk_capture_ms=r["chunked_graphed"]["capture_ms"])
    summary.update(
        prefill_ttft_ms_p50=float(np.median(bf16["prefill_ttft_ms"])),
        hop_ms_p50=bf16["hop_ms_p50"],
        bf16_spliced_equal=[bf16["equal_uninterrupted"], bf16["streams"]],
        f32_spliced_equal=[f32["equal_uninterrupted"], f32["streams"]],
        drain_grace_frame_s=grace["migrate_frame_s_after_sigterm"])
    for kind in ("dense", "paged"):
        summary[kind].update(
            bf16_chunked_equal_plain=[storm[kind]["chunked_graphed"][
                "requests_equal_plain"], STORM_REQUESTS],
            bf16_chunked_tokens_equal_plain=[storm[kind]["chunked_graphed"][
                "tokens_equal_plain"], STORM_REQUESTS],
            f32_burst_chunked_equal_plain=[burst32[kind]["chunked_graphed"][
                "requests_equal_plain"], STORM_REQUESTS])
    out = dict(summary=summary, storm=storm, burst=burst,
               burst_f32=burst32, gemm_row_invariance=gemm,
               handoffs_bf16=bf16,
               handoffs_f32=f32, drain_grace=grace, launches=launches,
               prefill_chunks=life[False]["prefill_chunks"]
               + life[True]["prefill_chunks"],
               decode_steps=life[False]["decode_steps"]
               + life[True]["decode_steps"], gates_failed=gates)
    return out


# ---------------------------------------------------------------------------
# Phase 3d: the int8 KV cache on both engines, and the engine's FaultLab
# sites
# ---------------------------------------------------------------------------


def kv_bytes(cache) -> int:
    """Device bytes of a KV cache or pool, scales included."""
    return sum(t.numel() * t.element_size() for t in cache.leaves())


def pages_back(eng) -> bool:
    kv = eng.metrics()["kv_cache"]
    return kv["blocks_free"] + kv["blocks_cached"] == kv["blocks_total"]


def int8_storage(eng, cfg, what: str, gates: list) -> dict:
    """K/V int8 and their scales f32, at (L, rows..., KH, D) and (L,
    rows..., KH): the dense cache's rows are (slots, max_seq), the pool's
    (blocks, block_len)."""
    c = eng._cache
    lead = (cfg.n_layers,) + tuple(c.k.shape[1:3])
    want = lead + (cfg.n_kv_heads, cfg.head_dim)
    ok = (c.quantized and c.k.dtype == c.v.dtype == torch.int8
          and c.kscale.dtype == c.vscale.dtype == torch.float32
          and tuple(c.k.shape) == tuple(c.v.shape) == want
          and tuple(c.kscale.shape) == tuple(c.vscale.shape) == want[:-1])
    if not ok:
        gates.append(f"{what}: KV storage {[(str(t.dtype), tuple(t.shape)) for t in c.leaves()]}, want int8 {want} and f32 {want[:-1]}")
    return dict(k=[str(c.k.dtype), list(c.k.shape)],
                kscale=[str(c.kscale.dtype), list(c.kscale.shape)])


@contextlib.contextmanager
def fault_watch(faultlab, eng):
    """Around faultlab.site: when a site injects, record the requests its
    containment class must fail, read from the engine at that moment (the
    JAX engine's classes): a dispatch or collect fault every live request,
    the slots' and the first tokens on their way; a prefill fault the
    request being prefilled; a paged admission fault none (its request
    stays queued); a commit fault the one request whose commit crossed the
    site (the request the calling commit loop holds at that crossing)."""
    seen = {}
    real = faultlab.site

    def site(name):
        try:
            real(name)
        except faultlab.InjectedFault:
            if name in ("engine.dispatch", "engine.collect"):
                live = {r.req_id for r in eng._slot_req if r is not None}
                live |= {p.req.req_id for p in eng._pending_first
                         if not p.req.done}
            elif name == "engine.prefill":
                live = {eng._prefill.req.req_id}
            elif name == "engine.commit":
                caller = sys._getframe(1)
                req = caller.f_locals.get("req")
                live = ({req.req_id} if req is not None
                        and caller.f_code.co_name == "_commit_chunk"
                        else {None})
            else:
                live = set()
            seen[name] = live
            raise
    faultlab.site = site
    try:
        yield seen
    finally:
        faultlab.site = real


def run_faults(dev, mods, cfg8, params, prompts, want, later, later_want,
               gates) -> dict:
    """One TargetedPlan a site on a fresh graphed paged int8 engine: the
    9 prompts at once, then `later` ones. The requests the fault's class
    fails are failed, by the site's cause, and no other; every other
    request, and every later one, has the unfaulted engine's tokens; no
    page is leaked."""
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    serving = mods[7]
    cause = {"engine.dispatch": "dispatch", "engine.collect": "collect",
             "engine.commit": "commit", "engine.prefill": "prefill",
             "engine.paged_admit": "prefill"}
    out = {}
    for site, occ in FAULT_TARGETS.items():
        eng = new_engine(serving, params, cfg8, dev,
                         kv_block_len=KV_BLOCK_LEN,
                         watchdog_timeout=WATCHDOG_S)
        faultlab.activate(faultlab.TargetedPlan({site: [occ]}))
        try:
            with fault_watch(faultlab, eng) as seen:
                first = transcripts(eng, prompts)
                after = transcripts(eng, later)
        finally:
            injected = faultlab.injections_total()
            faultlab.deactivate()
        errored = {r.req_id for r in first if r.finish_reason == "error"}
        errors = eng.metrics()["resilience"]["errors"]
        expect = seen.get(site)
        if injected != 1 or expect is None:
            gates.append(f"faults: {site}#{occ} injected {injected} times")
            continue
        if errored != expect:
            gates.append(f"faults: {site} failed requests {sorted(errored)}"
                         f", its class fails {sorted(expect)}")
        if {k: v for k, v in errors.items() if v} != {cause[site]: 1}:
            gates.append(f"faults: {site} counted errors {errors}")
        for r, w in zip(first, want):
            if r.req_id not in errored and (r.finish_reason != "length"
                                            or r.tokens != w):
                gates.append(f"faults: {site}: untouched request "
                             f"{r.req_id} ended {r.finish_reason}, tokens "
                             f"diverge at {divergence(r.tokens, w)}")
        if [r.tokens for r in after] != later_want or any(
                r.finish_reason != "length" for r in after):
            gates.append(f"faults: {site}: later requests differ from the "
                         f"unfaulted engine's")
        if not pages_back(eng):
            gates.append(f"faults: {site}: pages leaked")
        if eng.metrics()["hotpath"]["graphs_captured"] != 1:
            gates.append(f"faults: {site}: the engine recaptured its graph")
        out[site] = dict(occurrence=occ, failed=sorted(errored),
                         class_fails=sorted(expect), errors=cause[site])
        del eng
    return out


def run_fault_serve(gates: list) -> dict:
    """A paged int8-KV serve main started with KTWE_FAULT_SEED=5,
    KTWE_FAULT_RATE=1.0, KTWE_FAULT_SITES=engine.commit: every commit
    fails, so each of two requests answers its error view, and
    /v1/metrics' faultlab block and ktwe_fault_injections_total on the
    metrics port count both injections."""
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
    env = {"KTWE_FAULT_SEED": "5", "KTWE_FAULT_RATE": "1.0",
           "KTWE_FAULT_SITES": "engine.commit"}
    os.environ.update(env)
    stop, got_port, ready, rc = (threading.Event(), threading.Event(), {},
                                 {})
    mport = free_port()
    argv = ["--device", "cuda", "--port", "0", "--int8-kv",
            "--kv-block-len", str(KV_BLOCK_LEN), "--metrics-port",
            str(mport)]

    def on_ready(port):
        ready["port"] = port
        got_port.set()
    th = threading.Thread(target=lambda: rc.update(rc=serve.main(
        argv, stop=stop, on_ready=on_ready)), daemon=True)
    th.start()
    views, block, series = [], {}, {}
    try:
        if not got_port.wait(600):
            fail("the FaultLab serve main did not come up")
        port = ready["port"]
        rng = np.random.default_rng(9)
        for _ in range(2):
            with post(port, {"prompt": rng.integers(
                    0, SERVE_DIMS["vocab_size"], 24).tolist(),
                    "maxNewTokens": 8, "timeoutSeconds": 300}) as resp:
                views.append(json.loads(resp.read()))
        block = get_metrics(port)["faultlab"]
        series = scrape(mport, serve.SERVING_FAMILIES)
    finally:
        stop.set()
        th.join(120)
        faultlab.deactivate()
        for k in env:
            os.environ.pop(k, None)
    if th.is_alive() or rc.get("rc") != 0:
        gates.append(f"the FaultLab serve main did not exit 0: {rc}")
    if [v.get("status") for v in views] != ["error", "error"] or not all(
            "site=engine.commit" in v.get("error", "") for v in views):
        gates.append(f"FaultLab serve views: {views}")
    if block.get("injections_by_site") != {"engine.commit": 2} or \
            series.get("ktwe_fault_injections_total") != 2.0:
        gates.append(f"FaultLab serve counters: {block}, {series}")
    return dict(views=[v.get("status") for v in views], faultlab=block,
                ktwe_fault_injections_total=series.get(
                    "ktwe_fault_injections_total"))


def int8_speed(dev, serving, params, cfg, card) -> dict:
    """Decode ms a token (the engine's p50) and tokens/s of the graphed
    dense engine, int8 against bf16 KV, at max_seq 256 and 4096: 8
    prompts of 128 tokens, INT8_SPEED_NEW new each; the KV bytes beside
    them. Printed, not gated."""
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
               for _ in range(NUM_SLOTS)]
    out = {}
    for max_seq in (cfg.max_seq, INT8_LONG_SEQ):
        for int8 in (False, True):
            c = dataclasses.replace(cfg, max_seq=max_seq,
                                    kv_cache_int8=int8)
            eng = new_engine(serving, params, c, dev)
            warm = eng.submit(prompts[0], 16)       # the capture
            eng.run()
            eng.release(warm)
            before = eng.metrics_snapshot()["lifetime"]
            t0 = time.perf_counter()
            rids = [eng.submit(p, INT8_SPEED_NEW) for p in prompts]
            eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reqs = [eng.result(r) for r in rids]
            steps = (eng.metrics_snapshot()["lifetime"]["decode_steps"]
                     - before["decode_steps"])
            out[f"{'int8' if int8 else 'bf16'}_{max_seq}"] = dict(
                card=card, kv_bytes=kv_bytes(eng._cache),
                decode_ms_per_token_p50=decode_p50_ms(reqs),
                tokens_per_s=sum(len(r.tokens) for r in reqs) / wall,
                decode_steps=steps, wall_s=wall)
            del eng
            torch.cuda.empty_cache()
    return out


def run_int8kv(dev, mods, cfg, params, card) -> dict:
    """The int8kv phase at the serve defaults, both engines with
    kv_cache_int8, graphed and pipelined, with the launch counters set to
    0 just before its bf16 engine runs and read just after. Gates: int8
    storage; graphed == eager bit for bit, greedy and sampled; every
    prefill chunk and decode step launching the gather, the norms, RoPE
    and flash as expected_launches counts them (dense decode attention for
    both engines) and the paged decode kernel never (the JAX engine's
    paged kernel is off under int8); no page leaked; prefill logits
    within 2 % of the bf16-KV logits' range; in f32, int8 dense == int8
    paged == the plain versions' engine, and an eject/resume and a
    preemption splice exactly; FaultLab's five engine sites on the graphed
    paged engine and a serve main started with KTWE_FAULT_*. Printed: the
    pools' bytes, int8 against bf16 KV at max_seq 256 and 4096, and how
    many bf16 greedy streams int8 and bf16 KV agree on."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    gates = []
    cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
    _, prompts = paged_requests(cfg.vocab_size)
    rng = np.random.default_rng(6)
    later = [rng.integers(0, cfg.vocab_size, PROMPT_LEN).tolist()
             for _ in range(4)]
    kinds = (("dense", 0), ("paged", KV_BLOCK_LEN))
    life = {"prefill_chunks": 0, "decode_steps": 0}
    graphed, storage, hot, bytes_kv = {}, {}, {}, {}
    kernels.reset_launches()
    with spying([(serving, "paged_decode_attention")]) as spied:
        for kind, bl in kinds:
            eng = new_engine(serving, params, cfg8, dev, kv_block_len=bl,
                             watchdog_timeout=WATCHDOG_S)
            greedy = transcripts(eng, prompts)
            sampled = transcripts(eng, prompts, SAMPLED_T)
            hot[kind] = check_graphed(eng, f"int8 {kind} engine")
            for k in life:
                life[k] += eng.metrics()["lifetime"][k]
            storage[kind] = int8_storage(eng, cfg, f"int8 {kind}", gates)
            bytes_kv[kind] = kv_bytes(eng._cache)
            if bl and not pages_back(eng):
                gates.append("int8 paged engine leaked pages")
            graphed[kind] = (greedy, sampled)
            del eng
        torch.cuda.synchronize()
    launches = dict(kernels.launches)
    want = expected_launches(cfg.n_layers, life)
    if launches != want:
        gates.append(f"int8kv launches {launches}, its chunks and steps "
                     f"need {want}")
    if launches.get("paged_decode", 0) or spied["paged_decode_attention"]:
        gates.append(f"int8 KV reached the paged decode kernel: "
                     f"{launches.get('paged_decode', 0)} launches, "
                     f"{spied['paged_decode_attention']} calls")
    for kind, bl in kinds:
        ref = new_engine(serving, params, cfg8, dev, kv_block_len=bl,
                         cuda_graph=False, overlap_commit=False)
        hold_to_eager(graphed[kind][0], transcripts(ref, prompts),
                      f"int8 {kind} engine (greedy)")
        hold_to_eager(graphed[kind][1], transcripts(ref, prompts,
                                                    SAMPLED_T),
                      f"int8 {kind} engine (sampled)")
        if bl:
            later_want = [r.tokens for r in transcripts(ref, later)]
        del ref
    bf16 = new_engine(serving, params, cfg, dev)
    bytes_bf16 = kv_bytes(bf16._cache)
    bf16_tokens = [r.tokens for r in transcripts(bf16, prompts)]
    del bf16
    agree = sum(r.tokens == w for r, w in zip(graphed["dense"][0],
                                               bf16_tokens))
    first8, _ = prefill_logits(decode, params, cfg8, prompts[0], dev)
    first16, _ = prefill_logits(decode, params, cfg, prompts[0], dev)
    logit_err = float((first8 - first16).abs().max())
    logit_range = float(first16.abs().max())
    if not logit_err < 0.02 * logit_range:
        gates.append(f"int8 KV prefill logits off by {logit_err}, 2 % of "
                     f"the bf16-KV range is {0.02 * logit_range}")
    faults = run_faults(dev, mods, cfg8, params, prompts,
                        [r.tokens for r in graphed["paged"][0]], later,
                        later_want, gates)
    fault_serve = run_fault_serve(gates)
    f32 = run_int8kv_f32(dev, mods, cfg8, params, prompts, gates)
    speed = int8_speed(dev, serving, params, cfg, card)
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", kv_cache_int8=True,
                    num_slots=NUM_SLOTS, prefill_len=PREFILL_LEN,
                    decode_chunk=DECODE_CHUNK, kv_block_len=KV_BLOCK_LEN),
        storage=storage, kv_bytes=dict(int8_dense=bytes_kv["dense"],
                                       int8_paged=bytes_kv["paged"],
                                       bf16_dense=bytes_bf16),
        hotpath=hot, graphed_equals_eager=dict(
            greedy=len(prompts) * 2, sampled=len(prompts) * 2),
        bf16_streams_int8_equal_bf16_kv=[agree, len(prompts)],
        prefill_logit_err=logit_err, prefill_logit_range=logit_range,
        faults=faults, fault_serve=fault_serve, f32=f32, speed=speed,
        spied_calls=spied, launches=launches,
        prefill_chunks=life["prefill_chunks"],
        decode_steps=life["decode_steps"], gates_failed=gates)


def run_int8kv_f32(dev, mods, cfg8, params, prompts, gates) -> dict:
    """The f32 gates under int8 KV: dense == paged == the plain versions'
    dense engine, token for token; a request ejected mid-stream from the
    dense engine resumes on another to the uninterrupted tokens; on the
    paged engine the newest of 8 decoding batch requests, preempted for an
    interactive one, resumes to its uninterrupted tokens, and the
    interactive request gets its own; no page leaked."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg8, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    dense = transcripts(new_engine(serving, p32, cfg32, dev), prompts)
    paged_eng = new_engine(serving, p32, cfg32, dev,
                           kv_block_len=KV_BLOCK_LEN)
    paged32 = transcripts(paged_eng, prompts)
    with plain_versions(rms, rope, flash):
        plain = transcripts(new_engine(serving, p32, cfg32, dev,
                                       cuda_graph=False), prompts)
    want = [r.tokens for r in dense]
    for what, got in (("paged", paged32), ("plain versions", plain)):
        if [r.tokens for r in got] != want:
            gates.append(f"f32 int8 KV: the {what} engine's tokens differ "
                         f"from the dense engine's (requests "
                         f"{[i for i, r in enumerate(got) if r.tokens != want[i]]})")
    if not pages_back(paged_eng):
        gates.append("f32 int8 paged engine leaked pages")
    lp = max(float(np.max(np.abs(np.subtract(a.logprobs, b.logprobs))))
             for a, b in zip(plain, dense))
    # Eject one decoding request of 8 and resume it on another engine.
    src = new_engine(serving, p32, cfg32, dev)
    rids = [src.submit(p, NEW_TOKENS) for p in prompts[:NUM_SLOTS]]
    for _ in range(1000):
        if len(src.result(rids[0]).tokens) >= MIGRATE_AFTER:
            break
        src.step()
    st = src.eject(rids[0])
    src.run()
    if st is None or not 0 < len(st["committed"]) < NEW_TOKENS:
        gates.append(f"f32 int8 KV: the eject gave {st}")
    else:
        res = resume_state_of(new_engine(serving, p32, cfg32, dev), st)
        if res.tokens != want[0]:
            gates.append(f"f32 int8 KV: the resumed stream diverges at "
                         f"{divergence(res.tokens, want[0])}")
    # Preempt the newest of 8 batch requests for an interactive one.
    eng = new_engine(serving, p32, cfg32, dev, kv_block_len=KV_BLOCK_LEN)
    bids = [eng.submit(p, NEW_TOKENS, priority="batch")
            for p in prompts[:NUM_SLOTS]]
    for _ in range(1000):
        if all(len(eng.result(r).tokens) >= MIGRATE_AFTER for r in bids):
            break
        eng.step()
    iid = eng.submit(prompts[NUM_SLOTS], NEW_TOKENS)
    eng.run()
    victims = [r for r in bids if eng.result(r).finish_reason == "migrated"]
    spliced = None
    if victims != [bids[-1]] or eng.result(iid).tokens != want[NUM_SLOTS]:
        gates.append(f"f32 int8 KV: preemption victims {victims}, "
                     f"interactive tokens equal "
                     f"{eng.result(iid).tokens == want[NUM_SLOTS]}")
    else:
        st = eng.result(bids[-1]).resume_state
        res = resume_state_of(new_engine(serving, p32, cfg32, dev,
                                         kv_block_len=KV_BLOCK_LEN), st)
        spliced = len(st["committed"])
        if res.tokens != want[NUM_SLOTS - 1] or st["reason"] != "preempt":
            gates.append(f"f32 int8 KV: the preempted stream diverges at "
                         f"{divergence(res.tokens, want[NUM_SLOTS - 1])}")
    if not pages_back(eng):
        gates.append("f32 int8 preemption engine leaked pages")
    del p32
    torch.cuda.empty_cache()
    return dict(dense_equals_paged_equals_plain=len(prompts),
                plain_logprob_max_abs_diff=lp,
                ejected_committed=len(st["committed"]) if st else None,
                preempted_committed=spliced)


# ---------------------------------------------------------------------------
# The spec phase: speculative decoding
# ---------------------------------------------------------------------------


class SwitchDrafter:
    """The spec engines' drafter, switched between traffics (`fn`: context,
    k -> drafts), with its host seconds counted."""

    def __init__(self):
        self.fn = None
        self.s = 0.0

    def __call__(self, context, k):
        t = time.perf_counter()
        try:
            return self.fn(context, k)
        finally:
            self.s += time.perf_counter() - t


def oracle_drafter(want: dict):
    """Drafts from known continuations: `want` maps a prompt (a tuple of
    PROMPT_LEN tokens) to the tokens the spec-off engine decoded after
    it."""
    def draft(context, k):
        cont = want.get(tuple(context[:PROMPT_LEN]), [])
        done = len(context) - PROMPT_LEN
        return cont[done:done + k]
    return draft


def adversarial_drafter(vocab: int):
    """A draft that is never the token the model just decoded plus one,
    over and over: wrong (all but) every time."""
    def draft(context, k):
        return [(int(context[-1]) + 1) % vocab] * k
    return draft


def spec_traffic(vocab: int) -> dict:
    """The spec phase's traffics: (a) the serving cell's 8 prompts of 128
    tokens, 48 new, drafted by an oracle of the spec-off transcripts; (b)
    8 prompts of a repeated 8-token cycle, 64 new, the n-gram drafter; (d)
    the serving cell's prompts, 4 greedy (the oracle) and 4 sampled at
    t 0.8; (c) the serving cell's prompts under the adversarial drafter
    (last: its collapse lowers the engine-wide acceptance that new
    admissions start from)."""
    rng = np.random.default_rng(0)          # run_engine's first 8 prompts
    cell = [rng.integers(0, vocab, PROMPT_LEN).tolist()
            for _ in range(N_REQUESTS)]
    rng = np.random.default_rng(SPEC_SEED)
    cycle = [rng.integers(0, vocab, SPEC_CYCLE).tolist()
             * (PROMPT_LEN // SPEC_CYCLE) for _ in range(N_REQUESTS)]
    mixed = [(p, NEW_TOKENS, {} if i < N_REQUESTS // 2 else dict(
        temperature=SAMPLED_T, prng_key=[SPEC_SEED, i]))
        for i, p in enumerate(cell)]
    return {"oracle": [(p, NEW_TOKENS, {}) for p in cell],
            "ngram": [(p, SPEC_NGRAM_NEW, {}) for p in cycle],
            "mixed": mixed,
            "adversarial": [(p, NEW_TOKENS, {}) for p in cell]}


def spec_drafters(speculative, want: dict, vocab: int) -> dict:
    oracle = oracle_drafter(want)
    return {"oracle": oracle, "ngram": speculative.NGramDrafter(3),
            "mixed": oracle, "adversarial": adversarial_drafter(vocab)}


def spec_off_runs(serving, params, cfg, dev, traffic, bl) -> dict:
    """The spec-off engine's requests of each traffic (the adversarial
    one is the oracle's prompts again), after a warm-up request."""
    eng = new_engine(serving, params, cfg, dev, kv_block_len=bl)
    run_all(eng, [(traffic["ngram"][0][0], 16, {})])
    out = {name: run_all(eng, traffic[name])
           for name in ("oracle", "ngram", "mixed")}
    out["adversarial"] = out["oracle"]
    if bl and not pages_back(eng):
        fail("spec-off paged engine leaked pages")
    return out


def bracket_replays(graph) -> list:
    """CUDA events around each replay of `graph` (its capture left out),
    taken as the replays run; read them after a synchronize."""
    events, replay = [], graph.replay

    def call(run):
        if not graph.captures:
            return replay(run)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        replay(run)
        ev[1].record()
        events.append(ev)
    graph.replay = call
    return events


def spec_engine(serving, params, cfg, dev, bl, **kw):
    """(a spec engine at spec_k SPEC_K, its switchable drafter)."""
    drafter = SwitchDrafter()
    return new_engine(serving, params, cfg, dev, kv_block_len=bl,
                      spec_k=SPEC_K, drafter=drafter, **kw), drafter


def drive_spec(eng, drafter, speculative, traffic, want) -> dict:
    """A spec engine through a warm-up request (its graphs' captures) and
    the traffics in order, its drafter switched between them. Per
    traffic: the requests, the spec counters' deltas and the drafter's
    host seconds."""
    drafters = spec_drafters(speculative, want, eng.cfg.vocab_size)
    drafter.fn = drafters["ngram"]
    run_all(eng, [(traffic["ngram"][0][0], 16, {})])
    out = {}
    for name in ("oracle", "ngram", "mixed", "adversarial"):
        drafter.fn = drafters[name]
        before, s0 = dict(eng.metrics()["spec"]), drafter.s
        reqs = run_all(eng, traffic[name])
        after = eng.metrics()["spec"]
        delta = {k: after[k] - before[k] for k in (
            "rounds_total", "bypass_rounds_total", "tokens_total",
            "draft_proposed_total", "draft_accepted_total")}
        delta["slot_rounds"] = sum(after["k_hist"]) - sum(before["k_hist"])
        out[name] = dict(reqs=reqs, spec=delta, draft_s=drafter.s - s0)
    if eng.kv_block_len and not pages_back(eng):
        fail("a spec paged engine leaked pages")
    return out


def spec_equal(runs: dict, ref: dict) -> dict:
    """Requests of each traffic whose tokens equal the reference's."""
    return {name: [sum(g.tokens == w.tokens for g, w in
                       zip(run["reqs"], ref[name])), len(ref[name])]
            for name, run in runs.items()}


def spec_report(runs: dict, off: dict, chunk_ms: list,
                verify_ms: list) -> dict:
    """Per traffic: tokens a round (and a slot-round), acceptance, bypass
    rounds, the drafter's host ms a verify round and a dispatch (verify
    and bypass rounds: the drafter runs at both), ms a token p50 against
    the spec-off engine's."""
    out = {}
    for name, run in runs.items():
        d = run["spec"]
        out[name] = dict(
            rounds=d["rounds_total"], bypass_rounds=d["bypass_rounds_total"],
            tokens_per_round=(d["tokens_total"] / d["rounds_total"]
                              if d["rounds_total"] else 0.0),
            tokens_per_slot_round=(d["tokens_total"] / d["slot_rounds"]
                                   if d["slot_rounds"] else 0.0),
            acceptance=(d["draft_accepted_total"]
                        / d["draft_proposed_total"]
                        if d["draft_proposed_total"] else 0.0),
            draft_host_ms_per_verify_round=(
                run["draft_s"] * 1e3 / d["rounds_total"]
                if d["rounds_total"] else 0.0),
            draft_host_ms_per_dispatch=(
                run["draft_s"] * 1e3
                / max(1, d["rounds_total"] + d["bypass_rounds_total"])),
            ms_per_token_p50=decode_p50_ms(run["reqs"]),
            ms_per_token_p50_spec_off=decode_p50_ms(off[name]))
    return dict(traffic=out,
                verify_round_device_ms_p50=float(np.median(verify_ms))
                if verify_ms else None,
                decode_step_device_ms_p50=float(np.median(chunk_ms))
                / DECODE_CHUNK if chunk_ms else None,
                verify_rounds_timed=len(verify_ms),
                chunks_timed=len(chunk_ms))


def run_spec_f32(dev, serving, speculative, params, cfg, traffic, gates):
    """The f32 gates: on both engines the spec engine's tokens equal the
    spec-off engine's in every traffic, (d)'s sampled streams included,
    with verify rounds (the oracle's guarantee them; on random weights the
    n-gram drafter finds few matches) and every oracle draft accepted."""
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = cast_params(params, torch.float32)
    out = {}
    for kind, bl in (("dense", 0), ("paged", KV_BLOCK_LEN)):
        off = spec_off_runs(serving, p32, cfg32, dev, traffic, bl)
        want = {tuple(p): r.tokens for (p, _, _), r in
                zip(traffic["oracle"], off["oracle"])}
        runs = drive_spec(*spec_engine(serving, p32, cfg32, dev, bl),
                          speculative, traffic, want)
        equal = spec_equal(runs, off)
        for name in runs:
            if equal[name][0] != equal[name][1]:
                gates.append(f"f32 {kind} spec engine: {name} requests "
                             f"{equal[name]} equal spec-off")
        if runs["oracle"]["spec"]["rounds_total"] <= 0:
            gates.append(f"f32 {kind}: no verify round")
        d = runs["oracle"]["spec"]
        if d["draft_accepted_total"] != d["draft_proposed_total"]:
            gates.append(f"f32 {kind} oracle acceptance "
                         f"{d['draft_accepted_total']} of "
                         f"{d['draft_proposed_total']}")
        out[kind] = dict(equal=equal, counters={
            name: run["spec"] for name, run in runs.items()})
        del runs, off
    del p32
    torch.cuda.empty_cache()
    return out


SPEC_BLOCK_KEYS = {"enabled", "k", "rounds_total", "bypass_rounds_total",
                   "tokens_total", "draft_proposed_total",
                   "draft_accepted_total", "acceptance_rate",
                   "tokens_per_round", "effective_tokens_per_step",
                   "k_hist"}


def run_spec_serve(serve, kernels, traffic, gates) -> dict:
    """A --spec-k 4 serve main with a metrics port answers 3 greedy
    requests of the cycle prompts: /v1/metrics has the `spec` block with
    the JAX engine's keys and its speculative dispatches counted (verify
    rounds where the n-gram drafter found a match, bypass rounds where it
    found none: random weights need not continue a cycle), the port serves
    98 families with the 8 spec ones at the table's values, and the
    launches are those of its chunks, steps and rounds. --spec-k 4 with
    --int8-kv is a parser error (exit 2)."""
    with contextlib.redirect_stderr(io.StringIO()) as err:
        try:
            serve.main(["--device", "cuda", "--spec-k", "4", "--int8-kv"])
            int8_exit = 0
        except SystemExit as e:
            int8_exit = e.code
    if int8_exit != 2 or "--int8-kv" not in err.getvalue():
        gates.append(f"--spec-k 4 --int8-kv exited {int8_exit}: "
                     f"{err.getvalue()[-200:]}")
    mport = free_port()
    kernels.reset_launches()
    main = ServeMain(serve, ["--device", "cuda", "--port", "0", "--seed",
                             "0", "--spec-k", str(SPEC_K), "--metrics-port",
                             str(mport)])
    try:
        for p, _, _ in traffic["ngram"][:3]:
            code, r = post_json(main.port, "/v1/generate",
                                {"prompt": p, "maxNewTokens": 32})
            if code != 200 or len(r.get("tokens", [])) != 32:
                gates.append(f"spec serve main: {code} {str(r)[:200]}")
        m = get_metrics(main.port)
        series = scrape(mport, serve.SERVING_FAMILIES)
    finally:
        main.close()
    launches = dict(kernels.launches)
    spec = m["spec"]
    want = expected_launches(SERVE_DIMS["n_layers"], m["lifetime"],
                             verify_rounds=spec["rounds_total"])
    if launches != want:
        gates.append(f"spec serve main launches {launches}, want {want}")
    if set(spec) != SPEC_BLOCK_KEYS or not spec["enabled"] \
            or spec["rounds_total"] + spec["bypass_rounds_total"] <= 0:
        gates.append(f"spec serve main: spec block {spec}")
    fam = {k: v for k, v in series.items() if "_spec_" in k}
    if len(series) != 98 or len(fam) != 8 or any(
            fam[k] != float(serve.SERVING_FAMILIES[k](
                m, m["slots_busy"], m["slots"])) for k in fam) \
            or fam["ktwe_serving_spec_rounds_total"] != spec["rounds_total"]:
        gates.append(f"spec serve main families: {len(series)} served, "
                     f"{fam}")
    return dict(spec=spec, families=len(series), spec_families=fam,
                lifetime=m["lifetime"], int8_kv_exit=int8_exit,
                launches=launches)


def run_spec_generate(dev, generate, decode, tf, kernels, gates) -> dict:
    """The generate main with --batch-size 1 --speculate-draft-layers 4
    --speculate-k 4 at its defaults (bf16): its "speculative" result;
    then the same speculative generation in f32 against the plain greedy
    one, token for token, with the launches of its forward passes (the
    flash kernel at 5 query rows at the stream's offset)."""
    argv = ["--batch-size", "1", "--speculate-draft-layers", "4",
            "--speculate-k", "4"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = generate.main(argv)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    spec = line.get("speculative") or {}
    if rc != 0 or not spec.get("rounds"):
        gates.append(f"generate main --speculate-*: rc {rc}, {line}")
    args = generate.build_parser().parse_args(argv)
    cfg = tf.TransformerConfig(
        vocab_size=args.vocab_size, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads or args.n_heads, d_ff=args.d_ff,
        max_seq=args.prompt_len + args.gen_len, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = tf.init_params(gen, cfg)
    prompt = torch.randint(0, cfg.vocab_size, (1, args.prompt_len),
                           generator=gen, device=dev)
    kernels.reset_launches()
    stats, toks = generate._run_speculative(args, cfg, params, prompt)
    launches = dict(kernels.launches)
    max_seq = args.prompt_len + args.gen_len + args.speculate_k + 1
    plain = decode.generate(params, prompt, args.gen_len, cfg,
                            max_seq=max_seq)
    if not torch.equal(toks, plain):
        gates.append(f"f32 generate_speculative diverges from the plain "
                     f"greedy generation at {divergence(toks[0].tolist(), plain[0].tolist())}")
    # Two runs (warm-up and timed); a run: the target's prefill and one
    # verify a round, the draft's prefill and k + 1 passes a round.
    n, k, layers = args.speculate_draft_layers, args.speculate_k, cfg.n_layers
    calls = [(layers, 1 + stats["rounds"]),
             (n, 1 + stats["rounds"] * (k + 1))]
    want = {"embed_gather": 2 * sum(c for _, c in calls),
            "rms_norm": 2 * sum((2 * nl + 1) * c for nl, c in calls),
            "rope": 2 * sum(2 * nl * c for nl, c in calls),
            "flash_attention": 2 * sum(nl * c for nl, c in calls)}
    if launches != want:
        gates.append(f"f32 generate_speculative launches {launches}, its "
                     f"passes need {want}")
    del params
    torch.cuda.empty_cache()
    return dict(main_bf16=spec, main_sample_tail=line.get("sample_tail"),
                main_plain={k: line.get(k) for k in (
                    "wall_s", "prefill_s", "tokens_per_s",
                    "decode_ms_per_token")},
                f32=dict(stats, equal_plain=bool(torch.equal(toks, plain)),
                         launches=launches))


def run_spec(dev, mods, cfg, params, card) -> dict:
    """The spec phase at the serve defaults, spec_k SPEC_K, bf16, graphed,
    on the dense and the paged engine (pages of 16), with the launch
    counters set to 0 just before each graphed spec engine is built and
    read after its traffics. Gates: the f32 twins of every traffic equal
    spec-off token for token (sampled streams included) with verify rounds
    (the n-gram traffic's counted: random weights need not continue a
    cycle); graphed == eager (the same traffics, cuda_graph=False) bit for
    bit, tokens and logprobs; one verify-graph capture an engine, whose
    replay launches the gather and the 2L+1 norms and nothing else (no
    paged decode, RoPE or flash); the launches exactly expected_launches
    with a verify round one decode step; the adversarial traffic's
    collapse to bypass chunks; no page leaked; the spec serve main; the
    generate main's speculation. Printed: the verify round's device ms
    against a decode step's (CUDA events around the replays), draft host
    ms a round, tokens a round and acceptance, and ms a token p50 spec
    against spec-off, per traffic and engine; the bf16 streams equal to
    spec-off, counted."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import generate
    from k8s_gpu_workload_enhancer_tpu_torch.models import speculative
    gates, out = [], {}
    t_phase = time.perf_counter()
    n_layers = cfg.n_layers
    traffic = spec_traffic(cfg.vocab_size)
    launches = {}
    verify_launches = {"embed_gather": 1, "rms_norm": 2 * n_layers + 1}
    for kind, bl in (("dense", 0), ("paged", KV_BLOCK_LEN)):
        off = spec_off_runs(serving, params, cfg, dev, traffic, bl)
        want = {tuple(p): r.tokens for (p, _, _), r in
                zip(traffic["oracle"], off["oracle"])}
        kernels.reset_launches()
        t0 = time.perf_counter()
        eng, drafter = spec_engine(serving, params, cfg, dev, bl,
                                   watchdog_timeout=WATCHDOG_S)
        verify_ev = bracket_replays(eng._verify_graph)
        chunk_ev = bracket_replays(eng._graph)
        graphed = drive_spec(eng, drafter, speculative, traffic, want)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        got = dict(kernels.launches)
        life = eng.metrics()["lifetime"]
        spec_total = eng.metrics()["spec"]
        want_l = expected_launches(n_layers, life, paged=bool(bl),
                                   verify_rounds=spec_total["rounds_total"])
        if got != want_l:
            gates.append(f"spec {kind} launches {got}, its chunks, steps "
                         f"and verify rounds need {want_l}")
        for k_, v in got.items():
            launches[k_] = launches.get(k_, 0) + v
        vg = eng._verify_graph
        if vg.captures != 1 or dict(vg.launches) != verify_launches:
            gates.append(f"spec {kind}: {vg.captures} verify captures, a "
                         f"replay launches {dict(vg.launches)}, want 1 and "
                         f"{verify_launches}")
        hp = eng.metrics()["hotpath"]
        if eng.metrics()["resilience"]["watchdog_trips"]:
            gates.append(f"spec {kind}: the watchdog tripped")
        verify_ms = [a.elapsed_time(b) for a, b in verify_ev]
        chunk_ms = [a.elapsed_time(b) for a, b in chunk_ev]
        del eng._verify_graph.replay, eng._graph.replay
        adv = graphed["adversarial"]["spec"]
        if adv["bypass_rounds_total"] <= 0 or \
                adv["draft_accepted_total"] > 0.2 * max(
                    1, adv["draft_proposed_total"]):
            gates.append(f"spec {kind}: the adversarial drafter did not "
                         f"collapse to bypass chunks: {adv}")
        for name in ("oracle", "mixed"):
            if graphed[name]["spec"]["rounds_total"] <= 0:
                gates.append(f"spec {kind} {name}: no verify round")
        del eng
        eager = drive_spec(*spec_engine(serving, params, cfg, dev, bl,
                                        cuda_graph=False,
                                        watchdog_timeout=WATCHDOG_S),
                           speculative, traffic, want)
        for name in graphed:
            hold_to_eager(graphed[name]["reqs"], eager[name]["reqs"],
                          f"spec {kind} engine ({name})")
            if graphed[name]["spec"] != eager[name]["spec"]:
                gates.append(f"spec {kind} {name}: graphed counters "
                             f"{graphed[name]['spec']}, eager "
                             f"{eager[name]['spec']}")
        out[kind] = dict(spec_report(graphed, off, chunk_ms, verify_ms),
                         bf16_equal_spec_off=spec_equal(graphed, off),
                         k_hist=spec_total["k_hist"], lifetime=life,
                         hotpath=hp, wall_s=wall_s, launches=got)
        del eager, off, graphed
        torch.cuda.empty_cache()
    out["f32"] = run_spec_f32(dev, serving, speculative, params, cfg,
                              traffic, gates)
    out["serve"] = run_spec_serve(serve, kernels, traffic, gates)
    for k_, v in out["serve"]["launches"].items():
        launches[k_] = launches.get(k_, 0) + v
    out["generate"] = run_spec_generate(dev, generate, decode, tf, kernels,
                                        gates)
    return dict(config=dict(SERVE_DIMS, dtype="bfloat16", spec_k=SPEC_K,
                            num_slots=NUM_SLOTS, prefill_len=PREFILL_LEN,
                            decode_chunk=DECODE_CHUNK,
                            kv_block_len=KV_BLOCK_LEN),
                card=card, **out, launches=launches,
                phase_wall_s=time.perf_counter() - t_phase,
                gates_failed=gates)


# ---------------------------------------------------------------------------
# Phase 5b: the host KV tier (models/kvhost.py)
# ---------------------------------------------------------------------------


def kvhost_traffic(vocab: int):
    """Wave A (prefixes 1-3 under their suffixes), wave B (prefixes 4-6),
    and A's re-arrivals (prefixes 1-3 under new suffixes)."""
    rng = np.random.default_rng(KVHOST_SEED)
    pre = [rng.integers(0, vocab, KVHOST_PREFIX).tolist()
           for _ in range(KVHOST_PREFIXES)]
    suf = [rng.integers(0, vocab, KVHOST_SUFFIX).tolist()
           for _ in range(KVHOST_PREFIXES + 3)]
    return ([pre[i] + suf[i] for i in range(3)],
            [pre[i] + suf[i] for i in range(3, 6)],
            [pre[i] + suf[6 + i] for i in range(3)])


def kvhost_engine(serving, params, cfg, dev, tier=True, **kw):
    """The paged engine at the serve defaults with the pool cut to
    KVHOST_BLOCKS pages (None: the auto pool, which holds every wave) and,
    with `tier`, a host tier of KVHOST_TIER blocks."""
    return new_engine(serving, params, cfg, dev, kv_block_len=KV_BLOCK_LEN,
                      kv_host_blocks=KVHOST_TIER if tier else 0, **kw)


def kvhost_waves(eng, traffic, marks=None) -> dict:
    """The three waves, each submitted at once and run to the end: every
    request, the re-arrivals' TTFTs, and the re-arrival wave's deltas of
    the tier's hits and prefetches and of the radix-matched blocks.
    `marks["wave"]` (when given) is the wave running."""
    reqs, before = [], None
    for i, prompts in enumerate(traffic):
        if marks is not None:
            marks["wave"] = i
        if i == 2:
            before = (dict(eng.metrics()["kvhost"]),
                      eng.metrics()["kv_cache"]["matched_tokens_total"])
        rids = [eng.submit(p, KVHOST_NEW) for p in prompts]
        eng.run()
        reqs += [eng.result(r) for r in rids]
    m = eng.metrics()
    return dict(
        reqs=reqs, again=reqs[6:],
        ttft_ms_again=[(r.first_token_at - r.submitted_at) * 1e3
                       for r in reqs[6:]],
        hits=m["kvhost"]["hits_total"] - before[0]["hits_total"],
        prefetches=(m["kvhost"]["prefetches_total"]
                    - before[0]["prefetches_total"]),
        matched_blocks=(m["kv_cache"]["matched_tokens_total"] - before[1])
        // KV_BLOCK_LEN)


def watch_demotions(eng) -> dict:
    """Around the radix eviction hook: digest -> the page's leaves cloned
    (on the compute stream, so in order) just before it is demoted, the
    digests in demotion order, and the host seconds each demotion (the
    tier's offload) took."""
    seen, order, host_s = {}, [], []
    real = eng._radix.on_evict

    def hook(node):
        seen[node.digest] = [t[:, node.block].clone()
                             for t in eng._cache.leaves()]
        order.append(node.digest)
        t0 = time.perf_counter()
        real(node)
        host_s.append(time.perf_counter() - t0)
    eng._radix.on_evict = hook
    return dict(pages=seen, order=order, host_s=host_s)


def restored_bit_for_bit(eng, demoted: dict, what: str, gates: list) -> int:
    """Every tree page whose block was demoted holds it bit for bit, leaf
    for leaf; returns how many pages were held."""
    torch.cuda.synchronize()
    n, stack = 0, list(eng._radix.root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        want = demoted["pages"].get(node.digest)
        if want is None:
            continue
        for leaf, got, w in zip(("k", "v", "kscale", "vscale"),
                                eng._cache.leaves(), want):
            if not torch.equal(got[:, node.block], w):
                gates.append(f"{what}: restored page {node.digest} differs "
                             f"from the demoted page in {leaf}")
        n += 1
    if n == 0:
        gates.append(f"{what}: no restored page to hold")
    return n


def time_tier(eng) -> dict:
    """Host seconds of each call of the tier's offload, fetch and restore,
    by wave (marks["wave"], set by kvhost_waves)."""
    marks = {"wave": None, "calls": []}
    tier = eng._host_tier
    for name in ("offload", "fetch", "restore"):
        real = getattr(tier, name)

        def timed(*a, _real=real, _name=name, **kw):
            t0 = time.perf_counter()
            try:
                return _real(*a, **kw)
            finally:
                marks["calls"].append((marks["wave"], _name,
                                       time.perf_counter() - t0))
        setattr(tier, name, timed)
    return marks


def tier_host_split(marks, wave: int) -> dict:
    """Calls and host ms (total, p50) of each tier method in one wave."""
    out = {}
    for name in ("offload", "fetch", "restore"):
        ms = [s * 1e3 for w, n, s in marks["calls"] if w == wave and n == name]
        out[name] = dict(calls=len(ms), ms_total=float(sum(ms)),
                         ms_p50=float(np.median(ms)) if ms else 0.0)
    return out


def host_costs(eng, reps: int = 20) -> dict:
    """Host ms of the pieces a tier call is made of, on one page: a
    pinned allocation of its leaves, the crc over its bytes."""
    leaves = [t[:, 1].clone() for t in eng._cache.leaves()]
    t0 = time.perf_counter()
    bufs = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in leaves] for _ in range(reps)]
    alloc_ms = (time.perf_counter() - t0) * 1e3 / reps
    arrays = dict(zip(("k", "v"), bufs[0]))
    t0 = time.perf_counter()
    for _ in range(reps):
        eng._host_tier._crc(arrays)
    crc_ms = (time.perf_counter() - t0) * 1e3 / reps
    del bufs
    return dict(pinned_alloc_ms_a_page=alloc_ms, crc_ms_a_page=crc_ms)


def tier_counters(eng) -> dict:
    m = dict(eng.metrics()["kvhost"])
    m.pop("dma_seconds_total")
    return m


def page_copy_ms(eng, reps: int = 20) -> dict:
    """Device ms of one page's copy to pinned host memory and back (every
    leaf), CUDA events around `reps` copies of page 1 each way, against
    its bytes over the host link."""
    leaves = eng._cache.leaves()
    stage = [t[:, 1].clone() for t in leaves]
    host = [torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
            for s in stage]
    nbytes = sum(s.numel() * s.element_size() for s in stage)

    def timed(fn):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def d2h():
        for h, s in zip(host, stage):
            h.copy_(s, non_blocking=True)

    def h2d():
        for t, h in zip(leaves, host):
            t[:, 1].copy_(h, non_blocking=True)
    d2h_ms, h2d_ms = timed(d2h), timed(h2d)
    return dict(page_bytes=nbytes, d2h_ms=d2h_ms, h2d_ms=h2d_ms,
                bound_ms=nbytes / HOST_LINK_BYTES_PER_S * 1e3,
                d2h_gb_s=nbytes / d2h_ms / 1e6, h2d_gb_s=nbytes / h2d_ms / 1e6)


def run_kvhost_faults(dev, serving, faultlab, params, cfg, traffic, want,
                      full_hits: int, dma_at: int, gates) -> dict:
    """One fault at each kvhost site on a fresh f32 tier engine: dma at the
    `dma_at`-th demotion (wave B's first of a block the re-arrivals need),
    fetch and corrupt at the first prefetch (the re-arrivals). The block
    it touches is re-prefilled (one tier hit fewer than the unfaulted
    engine's), every request has the tier-off engine's tokens, and the
    fault is counted as the JAX tier counts it."""
    out = {}
    for site, counter, occ in (("kvhost.dma", "dma_failures_total", dma_at),
                               ("kvhost.fetch", "dma_failures_total", 0),
                               ("kvhost.corrupt", "corrupt_drops_total", 0)):
        eng = kvhost_engine(serving, params, cfg, dev,
                            kv_num_blocks=KVHOST_BLOCKS)
        faultlab.activate(faultlab.TargetedPlan({site: [occ]}))
        try:
            got = kvhost_waves(eng, traffic)
        finally:
            snap = faultlab.snapshot()
            faultlab.deactivate()
        m = eng.metrics()["kvhost"]
        toks = [r.tokens for r in got["reqs"]]
        if toks != want:
            gates.append(f"{site} fault: tokens differ from the tier-off "
                         f"engine's")
        if snap["injections_by_site"] != {site: 1} or m[counter] != 1:
            gates.append(f"{site} fault: injections "
                         f"{snap['injections_by_site']}, {counter} "
                         f"{m[counter]}; want one")
        if got["hits"] >= full_hits:
            gates.append(f"{site} fault: {got['hits']} tier hits, the "
                         f"unfaulted engine's {full_hits}: nothing "
                         f"re-prefilled")
        if not all(r.finish_reason == "length" for r in got["reqs"]):
            gates.append(f"{site} fault failed a request")
        if not pages_back(eng):
            gates.append(f"{site} fault: pages leaked")
        out[site] = dict(injections=snap["injections_by_site"],
                         rearrival_hits=got["hits"],
                         **{k: m[k] for k in ("dma_failures_total",
                                              "corrupt_drops_total",
                                              "offloads_total", "hits_total",
                                              "prefetches_total")})
        del eng
    return out


def run_kvhost_f32(dev, serving, faultlab, params, cfg, traffic,
                   gates) -> dict:
    """The f32 twin at the same widths: the tier engine's tokens equal
    those of a tier-off engine whose auto pool holds every wave, and the
    three faults (run_kvhost_faults)."""
    from k8s_gpu_workload_enhancer_tpu_torch.models import kvhost
    p32 = cast_params(params, torch.float32)
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    ref = kvhost_engine(serving, p32, c32, dev, tier=False)
    want = [r.tokens for r in kvhost_waves(ref, traffic)["reqs"]]
    del ref
    eng = kvhost_engine(serving, p32, c32, dev, kv_num_blocks=KVHOST_BLOCKS)
    demoted = watch_demotions(eng)
    got = kvhost_waves(eng, traffic)
    # The first demotion of a block the re-arrivals restore: where the dma
    # fault must strike to cost a re-prefill.
    needed = {d for p in traffic[2]
              for d in kvhost.prompt_digests(p[:KVHOST_PREFIX],
                                             KV_BLOCK_LEN)}
    dma_at = next(i for i, d in enumerate(demoted["order"]) if d in needed)
    if [r.tokens for r in got["reqs"]] != want:
        gates.append("kvhost f32: the tier engine's tokens differ from the "
                     "tier-off engine's")
    if got["hits"] < got["matched_blocks"] or got["hits"] <= 0:
        gates.append(f"kvhost f32: {got['hits']} tier hits for "
                     f"{got['matched_blocks']} matched blocks")
    tier = tier_counters(eng)
    del eng, demoted
    faults = run_kvhost_faults(dev, serving, faultlab, p32, c32, traffic,
                               want, got["hits"], dma_at, gates)
    del p32
    torch.cuda.empty_cache()
    return dict(requests=len(want), equal_tier_off=len(want), tier=tier,
                dma_fault_at=dma_at, faults=faults)


def run_kvhost_serve(serve, traffic, gates) -> dict:
    """Two --kv-host-blocks serve mains at the serve defaults (pool cut
    alike): A serves waves A and B, so A's pages go to its tier; A's
    /v1/kvhost exports the first prompt's digests, B imports them and
    serves that prompt with a prefetch hit and A's tokens. A's /v1/metrics
    kvhost block and the 8 kvhost families on its metrics port; the
    parser error without --kv-block-len."""
    from k8s_gpu_workload_enhancer_tpu_torch.models import kvhost
    base = ["--device", "cuda", "--port", "0", "--seed", "0",
            "--kv-block-len", str(KV_BLOCK_LEN), "--kv-num-blocks",
            str(KVHOST_BLOCKS), "--kv-host-blocks", str(KVHOST_TIER)]
    mport = free_port()
    families = [f for f in serve.SERVING_FAMILIES
                if f.startswith("ktwe_serving_kvhost_")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        a = ServeMain(serve, base + ["--metrics-port", str(mport)])
        b = ServeMain(serve, base)
        try:
            body = lambda p: {"prompt": p, "maxNewTokens": KVHOST_NEW}  # noqa: E731
            first = concurrent(a.port, [body(p) for p in traffic[0]])
            concurrent(a.port, [body(p) for p in traffic[1]])
            # Wave A's prompts' digests; the pages wave B left on A's device
            # are not in its tier. The prompt with the longest chain from
            # the root in the tier is the one B serves.
            chains = [kvhost.prompt_digests(p, KV_BLOCK_LEN)
                      for p in traffic[0]]
            code, exp = post_json(a.port, "/v1/kvhost", {
                "digests": [d for c in chains for d in c]})
            entries = exp.get("entries", [])
            shipped = {e["digest"] for e in entries}
            depth = [next((i for i, d in enumerate(c) if d not in shipped),
                          len(c)) for c in chains]
            pick = int(np.argmax(depth))
            code_i, imp = post_json(b.port, "/v1/kvhost",
                                    {"entries": entries})
            got = concurrent(b.port, [body(traffic[0][pick])])[0]
            code_bad, bad = post_json(b.port, "/v1/kvhost", {})
            block_a = get_metrics(a.port)["kvhost"]
            block_b = get_metrics(b.port)["kvhost"]
            series = scrape(mport, serve.SERVING_FAMILIES)
        finally:
            a.close()
            b.close()
    if code != 200 or not entries or code_i != 200 or \
            imp.get("imported") != len(entries):
        gates.append(f"/v1/kvhost: export {code} with {len(entries)} "
                     f"entries, import {code_i} {imp}")
    if got["tokens"] != first[pick]["tokens"]:
        gates.append("/v1/kvhost: the importing replica's tokens differ "
                     "from the exporting replica's")
    restorable = min(depth[pick], (len(traffic[0][pick]) - 1)
                     // KV_BLOCK_LEN)
    if block_b["hits_total"] != restorable or restorable < 1 or \
            block_b["prefetches_total"] != restorable:
        gates.append(f"/v1/kvhost: no prefetch hit on the importer: "
                     f"{block_b}")
    if code_bad != 400 or bad.get("error") != \
            'kvhost request needs "digests" or "entries"':
        gates.append(f"/v1/kvhost {{}}: {code_bad} {bad}")
    want_keys = {"enabled", "capacity", "blocks_used", "offloads_total",
                 "prefetches_total", "hits_total", "discards_total",
                 "corrupt_drops_total", "dma_failures_total",
                 "dma_seconds_total", "imports_total", "exports_total",
                 "block_len", "bloom", "bloom_bits", "bloom_hashes"}
    if set(block_a) != want_keys or not block_a["bloom"] or \
            block_a["offloads_total"] <= 0:
        gates.append(f"serve kvhost block: {sorted(block_a)}")
    if len(families) != 8 or any(
            series.get(f) != float(serve.SERVING_FAMILIES[f](
                {"kvhost": block_a}, 0, 0)) for f in families
            if f != "ktwe_serving_kvhost_dma_seconds_total"):
        gates.append(f"kvhost families: {[(f, series.get(f)) for f in families]}")
    try:
        with contextlib.redirect_stderr(io.StringIO()) as err:
            serve.main(["--kv-host-blocks", "4"])
        rc = 0
    except SystemExit as e:
        rc = e.code
    if rc != 2 or "--kv-host-blocks requires --kv-block-len > 0" not in \
            err.getvalue():
        gates.append(f"--kv-host-blocks without --kv-block-len exited {rc}")
    return dict(exported=len(entries), imported=imp.get("imported"),
                served_prompt=pick, chain_in_tier=depth,
                importer=dict(hits_total=block_b["hits_total"],
                              prefetches_total=block_b["prefetches_total"],
                              imports_total=block_b["imports_total"]),
                exporter={k: block_a[k] for k in (
                    "offloads_total", "blocks_used", "exports_total")},
                families={f: series[f] for f in families},
                parser_error_exit=rc)


def run_kvhost(dev, mods, cfg, params, card) -> dict:
    """The kvhost phase at the serve defaults (bf16, graphed, 8 slots,
    pages of 16) with the pool cut from the auto 129 pages to
    KVHOST_BLOCKS so that prefixes are evicted, a host tier of KVHOST_TIER
    blocks, the launch counters set to 0 just before the graphed tier
    engine is built and read after its waves. Gates: every restored page
    equal to the page demoted, bit for bit (k and v; an int8 engine's k, v
    and scales); graphed == eager with the tier on (tokens, logprobs and
    tier counters); the re-arrivals' matched blocks all tier hits; the
    launches exactly expected_launches; no page leaked; the f32 twin's
    tokens equal a tier-off engine's whose pool holds everything, and the
    three kvhost faults contained (run_kvhost_f32); the serve mains
    (run_kvhost_serve). Printed: TTFT p50 of the prefetched re-arrivals
    against the same re-arrivals re-prefilled with the tier off (same pool);
    one page's copy each way in device ms against the host link; the tier's
    dma seconds a block (the JAX tier's meter: dispatch to the lazy
    finalize, and a restore's host time); the host ms an offload adds to an
    admission; the pinned host bytes; the bf16 streams equal to the tier-off
    engine's, counted."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    from k8s_gpu_workload_enhancer_tpu_torch import faultlab
    gates = []
    t_phase = time.perf_counter()
    traffic = kvhost_traffic(cfg.vocab_size)
    kernels.reset_launches()
    eng = kvhost_engine(serving, params, cfg, dev,
                        kv_num_blocks=KVHOST_BLOCKS,
                        watchdog_timeout=WATCHDOG_S)
    demoted = watch_demotions(eng)
    marks = time_tier(eng)
    graphed = kvhost_waves(eng, traffic, marks)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    life = eng.metrics()["lifetime"]
    want = expected_launches(cfg.n_layers, life, paged=True)
    if launches != want:
        gates.append(f"kvhost launches {launches}, its chunks and steps "
                     f"need {want}")
    held = restored_bit_for_bit(eng, demoted, "kvhost bf16", gates)
    check_graphed(eng, "kvhost engine")
    hp = hotpath_report(eng)
    if graphed["hits"] < graphed["matched_blocks"] or graphed["hits"] <= 0:
        gates.append(f"kvhost: {graphed['hits']} tier hits for "
                     f"{graphed['matched_blocks']} matched blocks")
    if not pages_back(eng):
        gates.append("kvhost engine leaked pages")
    tier = eng._host_tier
    m = eng.metrics()["kvhost"]
    counters = tier_counters(eng)
    copies = page_copy_ms(eng)
    host = dict(
        pinned_bytes=tier.host_bytes(),
        dma_seconds_total=m["dma_seconds_total"],
        dma_s_per_block=m["dma_seconds_total"] / max(
            1, m["offloads_total"] + m["prefetches_total"]),
        offload_host_ms_p50=float(np.median(demoted["host_s"])) * 1e3,
        offload_host_ms_mean=float(np.mean(demoted["host_s"])) * 1e3,
        offloads_timed=len(demoted["host_s"]),
        wave_b=tier_host_split(marks, 1),
        rearrivals=tier_host_split(marks, 2), **host_costs(eng))
    del eng, demoted
    eager = kvhost_engine(serving, params, cfg, dev,
                          kv_num_blocks=KVHOST_BLOCKS, cuda_graph=False,
                          overlap_commit=False)
    hold_to_eager(graphed["reqs"], kvhost_waves(eager, traffic)["reqs"],
                  "kvhost engine")
    if tier_counters(eager) != counters:
        gates.append(f"kvhost: graphed counters {counters}, eager "
                     f"{tier_counters(eager)}")
    del eager
    off = kvhost_waves(kvhost_engine(serving, params, cfg, dev, tier=False,
                                     kv_num_blocks=KVHOST_BLOCKS), traffic)
    equal = sum(g.tokens == o.tokens for g, o in zip(graphed["reqs"],
                                                     off["reqs"]))
    cfg8 = dataclasses.replace(cfg, kv_cache_int8=True)
    eng8 = kvhost_engine(serving, params, cfg8, dev,
                         kv_num_blocks=KVHOST_BLOCKS)
    demoted8 = watch_demotions(eng8)
    int8 = kvhost_waves(eng8, traffic)
    held8 = restored_bit_for_bit(eng8, demoted8, "kvhost int8", gates)
    if not pages_back(eng8) or int8["hits"] <= 0:
        gates.append(f"kvhost int8: {int8['hits']} hits, pages back "
                     f"{pages_back(eng8)}")
    del eng8, demoted8
    torch.cuda.empty_cache()
    f32 = run_kvhost_f32(dev, serving, faultlab, params, cfg, traffic, gates)
    served = run_kvhost_serve(serve, traffic, gates)
    return dict(
        config=dict(SERVE_DIMS, dtype="bfloat16", num_slots=NUM_SLOTS,
                    prefill_len=PREFILL_LEN, decode_chunk=DECODE_CHUNK,
                    kv_block_len=KV_BLOCK_LEN, kv_num_blocks=KVHOST_BLOCKS,
                    kv_num_blocks_cut_from=NUM_SLOTS * SERVE_DIMS["max_seq"]
                    // KV_BLOCK_LEN + 1, kv_host_blocks=KVHOST_TIER,
                    prefixes=KVHOST_PREFIXES, prefix=KVHOST_PREFIX,
                    suffix=KVHOST_SUFFIX, new_tokens=KVHOST_NEW),
        card=card, tier=counters,
        rearrivals=dict(hits=graphed["hits"],
                        prefetches=graphed["prefetches"],
                        matched_blocks=graphed["matched_blocks"]),
        ttft_p50_ms_prefetched=float(np.median(graphed["ttft_ms_again"])),
        ttft_p50_ms_reprefilled=float(np.median(off["ttft_ms_again"])),
        ttft_ms_prefetched=graphed["ttft_ms_again"],
        ttft_ms_reprefilled=off["ttft_ms_again"],
        page_copy=copies, host=host, pages_held_bit_for_bit=held,
        int8=dict(pages_held_bit_for_bit=held8, hits=int8["hits"]),
        bf16_streams_equal_tier_off=[equal, len(graphed["reqs"])],
        graphed_equals_eager=len(graphed["reqs"]), hotpath=hp,
        lifetime=life, f32=f32, serve=served, launches=launches,
        phase_wall_s=time.perf_counter() - t_phase, gates_failed=gates)


# ---------------------------------------------------------------------------
# Phase 6: where a step's device time goes
# ---------------------------------------------------------------------------


def profile_window(run) -> dict:
    """torch.profiler over one training step. `run(on_step)` trains two
    steps and calls on_step(i, metrics) after each (a step ends in a host
    read of its loss); the window opens after step 0 and closes after step
    1, outside every timed phase. Returns `device_report` of the
    window."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    marks = {}

    def on_step(i, metrics):
        torch.cuda.synchronize()
        if i == 0:
            prof.start()
            marks["start"] = time.perf_counter()
        elif i == 1:
            marks["end"] = time.perf_counter()
            prof.stop()
    rc = run(on_step)
    if isinstance(rc, int) and rc != 0:
        fail(f"profiled run exited {rc}")
    return device_report(prof, (marks["end"] - marks["start"]) * 1e3)


def device_spans(prof) -> list:
    """(name, start µs, end µs) of every device event of a profiler."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def device_report(prof, window_ms: float, events=None) -> dict:
    """A profiler window's device activity: the ten device operations with
    the most self time, the flash, fused CE, RMSNorm and paged decode
    kernels' device ms, and the idle share 1 - (union of device activity) /
    (the window's host wall time). `events`, when given, are the window's
    (name, start µs, end µs) device events in place of the profiler's."""
    spans, by_name = [], {}
    for name, t0, t1 in (device_spans(prof) if events is None else events):
        spans.append((t0, t1))
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for t0, t1 in sorted(spans):
        if t1 > reach:
            busy_us += t1 - max(t0, reach)
            reach = t1
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(window_ms=window_ms, device_ops=len(spans),
                device_busy_ms=busy_us / 1e3,
                idle_share=1.0 - busy_us / 1e3 / window_ms,
                flash_fwd_ms=sum(ms for n, ms in by_name.items()
                                 if "flash_fwd" in n),
                fused_ce_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                             for k in ("ce_wgmma_kernel<true>",
                                       "ce_wgmma_kernel<false>",
                                       "ce_dlg_kernel", "ce_combine_kernel",
                                       "ce_fwd_kernel", "ce_bwd_kernel")},
                flash_bwd_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                              for k in ("flash_bwd_dq_kernel",
                                        "flash_bwd_dq_wgmma",
                                        "flash_bwd_dq_wide_wgmma",
                                        "flash_bwd_dkv_kernel",
                                        "flash_bwd_dkv_wgmma",
                                        "flash_bwd_dkv_stash_kernel",
                                        "flash_bwd_dkv_stash_wgmma")},
                rms_ms={k: sum(ms for n, ms in by_name.items() if k in n)
                        for k in ("rms_norm_fwd_kernel", "rms_norm_bwd_kernel",
                                  "rms_dw_finalize_kernel")},
                paged_decode_ms={k: sum(ms for n, ms in by_name.items()
                                        if k in n)
                                 for k in ("paged_decode_mma_kernel",
                                           "paged_decode_simt_kernel",
                                           "paged_decode_combine_kernel")},
                top=[dict(name=n[:160], self_ms=ms, share=ms / window_ms)
                     for n, ms in top])


def profile_steps(trainer_cli, trainer, flagship) -> dict:
    """The profiler window on a step of the trainer main at its defaults
    and on a flagship step of one microbatch of 8 (grad_accum 1)."""
    collect_garbage()
    argv = ["--device", "cuda", "--steps", "2", "--batch-size",
            str(TRAIN_BATCH), "--seed", "0"]
    with contextlib.redirect_stdout(io.StringIO()):
        train = profile_window(
            lambda cb: trainer_cli.main(argv, callback=cb))
    collect_garbage()
    model_cfg, train_cfg = flagship.flagship_configs(
        batch_size=FLAGSHIP_MICRO, grad_accum=1)
    micro = profile_window(lambda cb: trainer.train_loop(
        model_cfg, train_cfg, num_steps=2, callback=cb, device="cuda"))
    collect_garbage()
    return {"train_step": train, "flagship_microbatch": micro}


def profile_serving(dev, mods, cfg, params) -> dict:
    """The profiler window on the paged engine at the serve defaults (pages
    of 16, bf16, the decode chunk one replayed CUDA graph under the
    overlapped pipeline): 8 greedy requests of the paged phase are admitted
    and prefilled first, then the window covers SERVING_WINDOW_STEPS engine
    steps of DECODE_CHUNK decode steps each over the 8 decoding slots,
    host work included, with a synchronize at either end. Besides the
    device report: ms a decode step, graph replays in the window, and the
    host's own ms a chunk (the window's wall less the time it waited on
    the chunk fetch, over the chunks). Then SERVING_WINDOW_STEPS steps
    unprofiled (`host_split`), and the same unprofiled window on a second
    engine whose 8 requests sample at SAMPLED_T (the dispatch draws their
    Gumbel noise on the host side)."""
    from torch.profiler import ProfilerActivity, profile
    serving = mods[7]
    _, prompts = paged_requests(cfg.vocab_size)
    eng, rids = window_engine(serving, params, cfg, dev, prompts)
    before = eng.metrics_snapshot()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t0 = time.perf_counter()
    for _ in range(SERVING_WINDOW_STEPS):
        eng.step()
    torch.cuda.synchronize()
    window_ms = (time.perf_counter() - t0) * 1e3
    prof.stop()
    after = eng.metrics_snapshot()
    steps = (after["lifetime"]["decode_steps"]
             - before["lifetime"]["decode_steps"])
    replays = (after["hotpath"]["graph_replays"]
               - before["hotpath"]["graph_replays"])
    fetch_ms = (after["hotpath"]["fetch_sync_s_total"]
                - before["hotpath"]["fetch_sync_s_total"]) * 1e3
    live = eng.slots_busy
    host = host_split(eng)
    finish_window(eng, rids, "greedy")
    del eng
    eng, rids = window_engine(serving, params, cfg, dev, prompts, SAMPLED_T)
    sampled = host_split(eng)
    finish_window(eng, rids, "sampled")
    del eng
    torch.cuda.empty_cache()
    report = device_report(prof, window_ms)
    paged_ms = sum(report["paged_decode_ms"].values())
    if live != NUM_SLOTS:
        fail(f"the serving window decoded {live} slots, want {NUM_SLOTS}")
    if replays != SERVING_WINDOW_STEPS:
        fail(f"the serving window replayed the decode graph {replays} "
             f"times, want {SERVING_WINDOW_STEPS}")
    return dict(decode_steps=steps, slots=live, graph_replays=replays,
                ms_per_decode_step=window_ms / max(1, steps),
                host_ms_per_chunk=(window_ms - fetch_ms) / max(1, replays),
                fetch_wait_ms=fetch_ms,
                paged_decode_share=paged_ms / window_ms,
                unprofiled=host, unprofiled_sampled=sampled, **report)


def window_engine(serving, params, cfg, dev, prompts, temperature=None):
    """A paged engine with NUM_SLOTS of `prompts` admitted in its first
    step (each generation, one page short of max_seq so that the 8
    reservations fit the auto pool without prefix sharing, outlasts the
    windows), stepped until every first token landed, then one
    decode-only step."""
    eng = new_engine(serving, params, cfg, dev, kv_block_len=KV_BLOCK_LEN,
                     prefill_interleave=2 * NUM_SLOTS)
    rids = [eng.submit(p, cfg.max_seq - len(p) - KV_BLOCK_LEN,
                       temperature=temperature)
            for p in prompts[:NUM_SLOTS]]
    while eng.metrics_snapshot()["queued"] or not all(
            eng.result(r).tokens for r in rids):
        eng.step()
    eng.step()
    return eng, rids


def finish_window(eng, rids, what: str) -> None:
    """Run a window engine to its end: every request runs its length on
    the one capture."""
    eng.run()
    if any(eng.result(r).finish_reason != "length" for r in rids):
        fail(f"the {what} serving window's requests did not finish")
    captures = eng.metrics()["hotpath"]["graphs_captured"]
    if captures != 1:
        fail(f"the {what} serving window captured {captures} decode "
             f"graphs, want 1")


def host_split(eng) -> dict:
    """SERVING_WINDOW_STEPS more engine steps without the profiler, each of
    the step's phases timed on the host clock: ms a decode step, and per
    chunk the admission, the fetch's wait, the dispatch (the noise draw
    and the graph replay call in it) and the commit. CUDA events bracket
    each replay and each noise draw on the stream, so the live chunks'
    device time is read in the window itself: `idle_share` is 1 - (the
    bracketed ms) / (the window's wall). A bracket opens when the stream
    reaches it, so where the device waited for the host's launches that
    wait is inside it: `idle_share` is a floor, and `idle_share_ceiling`
    takes the bracketed calls' host ms out (the most such a wait can
    be)."""
    names = ("_admit", "_fetch", "_dispatch_chunk", "_commit_phase")
    spent = {n: 0.0 for n in names + ("_draw_noise", "replay")}
    brackets = {"_draw_noise": [], "replay": []}

    def timed(key, fn):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return call

    def bracketed(key, fn):
        def call(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(*a, **kw)
            ev[1].record()
            brackets[key].append(ev)
        return timed(key, call)
    for n in names:
        setattr(eng, n, timed(n, getattr(eng, n)))
    eng._draw_noise = bracketed("_draw_noise", eng._draw_noise)
    eng._graph.replay = bracketed("replay", eng._graph.replay)
    before = eng.metrics_snapshot()["lifetime"]["decode_steps"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVING_WINDOW_STEPS):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = eng.metrics_snapshot()["lifetime"]["decode_steps"] - before
    for n in names + ("_draw_noise",):
        delattr(eng, n)
    del eng._graph.replay
    if len(brackets["replay"]) != SERVING_WINDOW_STEPS:
        fail(f"the unprofiled window replayed {len(brackets['replay'])} "
             f"chunks, want {SERVING_WINDOW_STEPS}")
    device_ms = {k: [a.elapsed_time(b) for a, b in v]
                 for k, v in brackets.items()}
    busy_ms = sum(map(sum, device_ms.values()))
    launch_ms = (spent["_draw_noise"] + spent["replay"]) * 1e3
    chunks = max(1, steps // DECODE_CHUNK)
    return dict(ms_per_decode_step=wall_ms / max(1, steps),
                chunk_device_ms=device_ms["replay"],
                noise_device_ms=device_ms["_draw_noise"],
                idle_share=1.0 - busy_ms / wall_ms,
                idle_share_ceiling=1.0 - max(0.0, busy_ms - launch_ms)
                / wall_ms,
                ms_per_chunk={k.strip("_"): v * 1e3 / chunks
                              for k, v in spent.items()})


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The moe phases, the capture census and the trace cell
# ---------------------------------------------------------------------------


def moe_param_count(tf, dims: dict) -> int:
    """Parameters of the model `dims` describe (from its leaf shapes; no
    tensor is made)."""
    def count(node):
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        return int(np.prod(node))
    return count(tf.param_shapes(tf.TransformerConfig(**dims)))


def weight_read_bytes(params) -> int:
    """Bytes a decode step reads of the weights: every leaf but the
    embedding table, whose gather reads one row a slot."""
    return sum(t.numel() * t.element_size() for k, t in
               zip(leaf_names(params), _leaves(params)) if k != "/embed")


def engine_prompts(vocab: int) -> list:
    """The dense engine phase's 9 prompts: 8 of PROMPT_LEN tokens, one of
    LONG_PROMPT_LEN (two prefill chunks)."""
    rng = np.random.default_rng(0)
    return ([rng.integers(0, vocab, PROMPT_LEN).tolist()
             for _ in range(N_REQUESTS)]
            + [rng.integers(0, vocab, LONG_PROMPT_LEN).tolist()])


def warmed_engine(serving, params, cfg, dev, prompt, **kw):
    """An engine after one short request: cuBLAS, the first launches and
    the decode graph's capture happen before anything is timed."""
    eng = new_engine(serving, params, cfg, dev, **kw)
    warm = eng.submit(prompt[:16], 4)
    eng.run()
    if eng.result(warm).finish_reason != "length":
        fail(f"warm-up request: {eng.result(warm)}")
    eng.release(warm)
    return eng


def chunk_device_ms(events: list) -> float:
    """Device ms a decode step: the median replay of a chunk over its
    DECODE_CHUNK steps (read after a synchronize)."""
    return float(np.median([a.elapsed_time(b) for a, b in events])) \
        / DECODE_CHUNK


def moe_engine_run(dev, mods, mcfg, mparams, dense_params, prompts, bl,
                   gates: list) -> dict:
    """One MoE engine kind (dense cache, or paged at pages of `bl`) at the
    serve defaults, bf16: the graphed, pipelined engine on the 9 prompts,
    greedy then sampled, its launches a dense model's per chunk and step;
    held bit for bit to the eager serialized engine; a spec engine
    (spec_k SPEC_K, an oracle drafter of the greedy tokens) graphed against
    eager, its verify graph's replay one gather and 2L+1 norms; the decode
    step's device ms against the dense model's engine in the same run."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    what = f"moe {'paged' if bl else 'dense'} engine"
    kw = dict(kv_block_len=bl)
    eng = warmed_engine(serving, mparams, mcfg, dev, prompts[0],
                        watchdog_timeout=WATCHDOG_S, **kw)
    events = bracket_replays(eng._graph)
    before = eng.metrics_snapshot()["lifetime"]
    kernels.reset_launches()
    t0 = time.perf_counter()
    greedy = transcripts(eng, prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    m = eng.metrics()
    life = {k: m["lifetime"][k] - before[k]
            for k in ("prefill_chunks", "decode_steps")}
    want = expected_launches(mcfg.n_layers, life, paged=bl > 0)
    if launches != want:
        gates.append(f"{what}: launches {launches}, a dense model's chunks "
                     f"and steps need {want}")
    moe_ms = chunk_device_ms(events)
    for r in greedy:
        if (r.finish_reason != "length" or len(r.tokens) != NEW_TOKENS
                or not all(np.isfinite(r.logprobs))):
            gates.append(f"{what}: a request ended {r.finish_reason} with "
                         f"{len(r.tokens)} tokens")
    sampled = transcripts(eng, prompts, SAMPLED_T)
    hp = check_graphed(eng, what)
    if bl and not pages_back(eng):
        gates.append(f"{what} leaked pages")
    ref = warmed_engine(serving, mparams, mcfg, dev, prompts[0],
                        cuda_graph=False, overlap_commit=False, **kw)
    hold_to_eager(greedy, transcripts(ref, prompts), f"{what} (greedy)")
    hold_to_eager(sampled, transcripts(ref, prompts, SAMPLED_T),
                  f"{what} (sampled)")
    del eng, ref
    # One verify round at least, graphed against eager.
    oracle = oracle_drafter({tuple(p): r.tokens for p, r in
                             zip(prompts[:N_REQUESTS], greedy)})
    spec = {}
    for mode, extra in (("graphed", {}), ("eager", dict(cuda_graph=False))):
        s_eng = warmed_engine(serving, mparams, mcfg, dev, prompts[0],
                              spec_k=SPEC_K, drafter=oracle, **kw, **extra)
        got = transcripts(s_eng, prompts[:N_REQUESTS])
        spec[mode] = (got, s_eng.metrics()["spec"],
                      s_eng._verify_graph)
        if bl and not pages_back(s_eng):
            gates.append(f"{what} (spec) leaked pages")
    (got, sm, vg), (eager, em, _) = spec["graphed"], spec["eager"]
    hold_to_eager(got, eager, f"{what} (spec)")
    if sm["rounds_total"] < 1 or sm != em:
        gates.append(f"{what} (spec): {sm['rounds_total']} verify rounds, "
                     f"graphed spec block equals eager's: {sm == em}")
    vl = dict(vg.launches)
    if vg.captures != 1 or vl != {"embed_gather": 1,
                                  "rms_norm": 2 * mcfg.n_layers + 1}:
        gates.append(f"{what} (spec): verify graph captures {vg.captures}, "
                     f"replay launches {vl}")
    # The dense model's decode step, same prompts, same call.
    dcfg = dataclasses.replace(mcfg, n_experts=0)
    deng = warmed_engine(serving, dense_params, dcfg, dev, prompts[0], **kw)
    dense_events = bracket_replays(deng._graph)
    dense_reqs = transcripts(deng, prompts)
    torch.cuda.synchronize()
    dense_ms = chunk_device_ms(dense_events)
    del deng
    torch.cuda.empty_cache()
    moe_bytes, dense_bytes = (weight_read_bytes(mparams),
                              weight_read_bytes(dense_params))
    return dict(
        wall_s=wall, tokens_per_s=m["aggregate_tokens_per_s"],
        ttft_p50_ms=m["ttft_p50_ms"],
        ms_per_token_p50=decode_p50_ms(greedy),
        sampled_ms_per_token_p50=decode_p50_ms(sampled),
        dense_model_ms_per_token_p50=decode_p50_ms(dense_reqs),
        decode_step_device_ms_p50=moe_ms,
        dense_model_decode_step_device_ms_p50=dense_ms,
        step_ratio=moe_ms / dense_ms,
        weight_bytes_a_step=moe_bytes,
        weight_read_bound_ms=moe_bytes / HBM_BYTES_PER_S * 1e3,
        dense_model_weight_bytes_a_step=dense_bytes,
        dense_model_weight_read_bound_ms=dense_bytes / HBM_BYTES_PER_S * 1e3,
        chunks_timed=len(events), graphed_equals_eager=dict(
            greedy=len(greedy), sampled=len(sampled), spec=len(got)),
        spec=dict(rounds=sm["rounds_total"],
                  accepted=sm["draft_accepted_total"],
                  verify_replay_launches=vl),
        hotpath=hp, decode_steps=life["decode_steps"],
        prefill_chunks=life["prefill_chunks"], launches=launches)


def run_moe_engines(dev, mods, dense_params, card) -> dict:
    """The MoE engines at the serve defaults with MOE_EXPERTS experts (the
    dense one-hot route at every decode step, captured), dense and paged,
    against eager engines and the dense model; then the f32 gate: the
    graphed dense and paged MoE engines' tokens equal the plain versions'
    eager engine's."""
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    collect_garbage()
    mcfg = tf.TransformerConfig(**SERVE_DIMS, n_experts=MOE_EXPERTS,
                                dtype=torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    mparams = serve._finish_params(tf.init_params(gen, mcfg), mcfg, False)
    prompts = engine_prompts(mcfg.vocab_size)
    gates, out = [], dict(card=card, config=dict(
        SERVE_DIMS, n_experts=MOE_EXPERTS, dtype="bfloat16",
        num_slots=NUM_SLOTS, prefill_len=PREFILL_LEN,
        decode_chunk=DECODE_CHUNK), params=moe_param_count(
            tf, dict(SERVE_DIMS, n_experts=MOE_EXPERTS)))
    out["dense"] = moe_engine_run(dev, mods, mcfg, mparams, dense_params,
                                  prompts, 0, gates)
    out["paged"] = moe_engine_run(dev, mods, mcfg, mparams, dense_params,
                                  prompts, KV_BLOCK_LEN, gates)
    # f32: graphed engines against the plain versions' eager engine.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = dataclasses.replace(mcfg, dtype=torch.float32)
    p32 = cast_params(mparams, torch.float32)
    del mparams
    with plain_versions(rms, rope, flash):
        plain = transcripts(new_engine(serving, p32, cfg32, dev,
                                       cuda_graph=False), prompts)
    want = [r.tokens for r in plain]
    f32 = {}
    for kind, bl in (("dense", 0), ("paged", KV_BLOCK_LEN)):
        got = transcripts(new_engine(serving, p32, cfg32, dev,
                                     kv_block_len=bl), prompts)
        f32[kind] = sum(g.tokens == w for g, w in zip(got, want))
        if f32[kind] != len(want):
            gates.append(f"f32 moe {kind} engine: {f32[kind]} of "
                         f"{len(want)} requests equal the plain versions'")
    out["f32_equal_plain"] = dict(f32, of=len(want))
    del p32
    torch.cuda.empty_cache()
    out["gates_failed"] = gates
    return out


class CensusDrafter:
    """Proposes nothing until `on`, then repeats the context's last token:
    a spec engine first dispatches a bypass chunk (its chunk graph), then
    verify rounds (its verify graph)."""

    def __init__(self):
        self.on = False

    def __call__(self, context, k):
        return [int(context[-1])] * k if self.on else []


def census_traffic(eng, drafter, vocab: int, seed: int) -> None:
    """A short request, two steps, then NUM_SLOTS + 1 more (one of
    LONG_PROMPT_LEN tokens, the rest of random lengths): prefills run
    while slots decode and requests wait (the quantum on a chunked
    engine); a spec engine's drafter switches on after the first
    dispatches."""
    rng = np.random.default_rng(seed)
    rids = [eng.submit(rng.integers(0, vocab, 9).tolist(), 24)]
    for _ in range(2):
        eng.step()
    if drafter is not None:
        drafter.on = True
    lens = [LONG_PROMPT_LEN] + rng.integers(8, PROMPT_LEN,
                                            NUM_SLOTS).tolist()
    rids += [eng.submit(rng.integers(0, vocab, n).tolist(),
                        int(rng.integers(16, 48))) for n in lens]
    eng.run()
    for r in rids:
        if eng.result(r).finish_reason != "length":
            fail(f"census request {r}: {eng.result(r)}")


CENSUS_GRAPHS = {"chunk": "_graph", "quantum": "_quantum_graph",
                 "verify": "_verify_graph"}


def run_census(dev, mods, card) -> dict:
    """The capture census at the serve defaults, under the program-event
    sentinel (analysis/compilewatch.py, enabled): an engine in each mode
    (dense and paged; plain, spec (spec_k SPEC_K), chunked prefill
    (STORM_CHUNK_TOKENS) and MoE (MOE_EXPERTS experts)), warmed by its
    first traffic, must have captured exactly its graphs (the chunk, the
    quantum when chunked prefill is on, the verify round when spec is
    on), each once, and the sentinel counted them and no kernel build or
    load; then steady traffic of new prompts and lengths and a weight swap
    on every engine: zero post-warm captures and zero kernel builds."""
    from k8s_gpu_workload_enhancer_tpu_torch.analysis import compilewatch
    kernels, rms, rope, flash, paged, tf, decode, serving, serve = mods
    collect_garbage()
    cfg = tf.TransformerConfig(**SERVE_DIMS, dtype=torch.bfloat16)
    mcfg = dataclasses.replace(cfg, n_experts=MOE_EXPERTS)

    def weights(c, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return serve._finish_params(tf.init_params(gen, c), c, False)
    params, mparams = weights(cfg, 10), weights(mcfg, 10)
    compilewatch.reset()
    compilewatch.enable(force=True)
    try:
        engines = []
        for bl, kind in ((0, "dense"), (KV_BLOCK_LEN, "paged")):
            modes = (("", {}, None, {"chunk": 1}),
                     ("-spec", dict(spec_k=SPEC_K), CensusDrafter(),
                      {"chunk": 1, "verify": 1}),
                     ("-chunked", dict(prefill_chunk_tokens=STORM_CHUNK_TOKENS),
                      None, {"chunk": 1, "quantum": 1}),
                     ("-moe", {}, None, {"chunk": 1}))
            for suffix, kw, drafter, want in modes:
                if drafter is not None:
                    kw = dict(kw, drafter=drafter)
                moe = suffix == "-moe"
                eng = new_engine(serving, mparams if moe else params,
                                 mcfg if moe else cfg, dev, kv_block_len=bl,
                                 **kw)
                engines.append((kind + suffix, eng, drafter, want, moe))
        t0 = time.perf_counter()
        for _, eng, drafter, _, _ in engines:
            census_traffic(eng, drafter, cfg.vocab_size, seed=0)
        warm_s = time.perf_counter() - t0
        census, total = {}, 0
        for name, eng, _, want, _ in engines:
            got = {g: getattr(eng, attr).captures
                   for g, attr in CENSUS_GRAPHS.items()
                   if getattr(eng, attr) is not None}
            census[name] = got
            total += sum(want.values())
            if got != want:
                fail(f"census: the {name} engine captured {got}, want {want}")
        warm_counts = compilewatch.counts()
        if warm_counts != {"capture": total}:
            fail(f"census: the sentinel counted {warm_counts} while warming, "
                 f"want {total} captures and no kernel build or load")
        compilewatch.mark_warm("census: every mode warm")
        new, mnew = weights(cfg, 11), weights(mcfg, 11)
        t0 = time.perf_counter()
        steady = {}
        for name, eng, drafter, _, moe in engines:
            before = eng.metrics()["lifetime"]
            census_traffic(eng, drafter, cfg.vocab_size, seed=1)
            eng.swap_params(mnew if moe else new)
            census_traffic(eng, drafter, cfg.vocab_size, seed=2)
            m = eng.metrics()
            steady[name] = {k: m["lifetime"][k] - before[k]
                            for k in ("prefill_chunks", "decode_steps")}
            if eng.kv_block_len and not pages_back(eng):
                fail(f"census: the {name} engine leaked pages")
        steady_s = time.perf_counter() - t0
        post = compilewatch.post_warm_compiles()
        counts = compilewatch.counts()
        if post or counts != warm_counts:
            fail(f"census: {len(post)} post-warm program events "
                 f"{counts}: {post[:4]}")
        compilewatch.verify()
        spec_rounds = {name: eng.metrics()["spec"]["rounds_total"]
                       for name, eng, d, _, _ in engines if d is not None}
        if min(spec_rounds.values()) < 1:
            fail(f"census: a spec engine ran no verify round {spec_rounds}")
        capture_ms = {name: {g: round(getattr(eng, a).capture_ms, 3)
                             for g, a in CENSUS_GRAPHS.items()
                             if getattr(eng, a) is not None}
                      for name, eng, _, _, _ in engines}
    finally:
        compilewatch.disable()
        compilewatch.reset()
    del engines, params, mparams, new, mnew
    torch.cuda.empty_cache()
    return dict(card=card, engines=len(census), captures=census,
                sentinel_warm_counts=warm_counts, post_warm_events=0,
                kernel_builds_post_warm=0, capture_ms=capture_ms,
                steady=steady, spec_rounds=spec_rounds, warm_s=warm_s,
                steady_s=steady_s)


def chrome_device_events(path: str, categories) -> list:
    """(name, start µs, end µs) of the device events of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("ph") == "X"
            and e.get("cat") in categories and "dur" in e]


def run_trace(dev, tf, trainer, profiling, card) -> dict:
    """The trace cell: `train.profiling.trace_steps` over TRACE_STEPS steps
    of the trainer's default configuration (bf16, batch TRAIN_BATCH, after
    one warm-up step), then `device_duty_cycle` of its Chrome trace, held
    within TRACE_POINTS of 100 x (1 - the idle share `device_report` gives
    for the same window: the union of the trace's device events over the
    steps' host wall time, from a synchronize before the first to the
    last loss's read). The two differ only at the window's edges, the
    host's time to the first launch and from the last device event, which
    the steps share."""
    collect_garbage()
    dims = {k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"}
    cfg = tf.TransformerConfig(**dims, n_kv_heads=dims["n_heads"],
                               max_seq=TRAIN_DIMS["seq_len"],
                               dtype=torch.bfloat16)
    tcfg = trainer.TrainConfig(batch_size=TRAIN_BATCH,
                               seq_len=TRAIN_DIMS["seq_len"])
    state = trainer.init_state(cfg, tcfg,
                               torch.Generator(device=dev).manual_seed(0))
    step = trainer.make_train_step(cfg, tcfg)
    batches = trainer.synthetic_batches(cfg, tcfg, dev)
    state, m = step(state, next(batches))
    float(m["loss"])                       # warm-up: cuBLAS, first launches
    marks = {}

    def timed(st, batch):
        torch.cuda.synchronize()
        marks.setdefault("start", time.perf_counter())
        st, met = step(st, batch)
        float(met["loss"])
        marks["end"] = time.perf_counter()
        return st, met
    with tempfile.TemporaryDirectory() as log_dir:
        state, m = profiling.trace_steps(timed, state, batches, log_dir,
                                         num_steps=TRACE_STEPS)
        duty = profiling.device_duty_cycle(log_dir)
        (name,) = os.listdir(log_dir)
        trace_bytes = os.path.getsize(os.path.join(log_dir, name))
        events = chrome_device_events(os.path.join(log_dir, name),
                                      profiling.DEVICE_CATEGORIES)
    if not events:
        fail("trace: the Chrome trace holds no device events")
    window_ms = (marks["end"] - marks["start"]) * 1e3
    span_ms = (max(e for _, _, e in events) - min(s for _, s, _ in events)
               ) / 1e3
    report = device_report(None, window_ms, events)
    busy_pct = 100.0 * (1.0 - report["idle_share"])
    if duty is None or abs(duty - busy_pct) > TRACE_POINTS:
        fail(f"trace: device_duty_cycle {duty} against 100 - idle "
             f"{busy_pct} (within {TRACE_POINTS} points)")
    if not np.isfinite(float(m["loss"])):
        fail(f"trace: loss {m['loss']}")
    del state, step
    collect_garbage()
    return dict(card=card, config=dict(TRAIN_DIMS, batch=TRAIN_BATCH,
                                       dtype="bfloat16"), steps=TRACE_STEPS,
                duty_cycle_pct=duty, busy_pct_of_window=busy_pct,
                idle_share=report["idle_share"], window_ms=window_ms,
                device_span_ms=span_ms, edge_ms=window_ms - span_ms,
                device_busy_ms=report["device_busy_ms"],
                device_ops=report["device_ops"], trace_bytes=trace_bytes,
                points_apart=duty - busy_pct, limit_points=TRACE_POINTS)


# The nvml phase: the node's device layer read while the port's flash
# forward keeps the card busy.
NVML_NODE = "smoke"
NVML_LOAD_S, NVML_WARM_S, NVML_SAMPLE_S, NVML_IDLE_WAIT_S = 4.0, 1.0, 0.25, 1.5
NVML_BUSY_MIN_PCT = 80.0
NVML_ALLOC_GIB, NVML_MEM_TOL_GIB = 4, 0.25
NVML_TOTAL_TOL_MIB, NVML_TEMP_TOL_C = 1.0, 3.0
# The exporter's busy scrapes against the client's read at each scrape:
# the median difference over the pairs, duty in points, power a share of
# the limit (the exporter's value is up to one collect interval older).
NVML_PAIRS, NVML_PAIR_DUTY_PTS, NVML_PAIR_POWER_FRAC = 5, 10.0, 0.1
NVML_HOST_READS = 100
_PROM_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def nvml_header_check(nvml) -> dict:
    """Compiles, with the host cc, a probe against the CUDA toolkit's
    nvml.h that prints the size, each field's offset and size of every
    structure discovery/nvml.py binds and the value of every constant it
    declares; fails on any that differs from the binding's."""
    include = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "include")
    header = os.path.join(include, "nvml.h")
    if not os.path.isfile(header):
        fail(f"nvml: the toolkit has no {header}")
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        fail("nvml: no host C compiler (cc) for the nvml.h check")
    want, lines = {}, []
    for cname, struct in nvml.STRUCTS.items():
        want[f"sizeof({cname})"] = ctypes.sizeof(struct)
        lines.append(f'printf("sizeof({cname}) %zu\\n", sizeof({cname}));')
        for fname, _ in struct._fields_:
            field = getattr(struct, fname)
            for key, value, expr in (
                    (f"offsetof({cname}, {fname})", field.offset,
                     f"offsetof({cname}, {fname})"),
                    (f"sizeof({cname}.{fname})", field.size,
                     f"sizeof((({cname} *)0)->{fname})")):
                want[key] = value
                lines.append(f'printf("{key} %zu\\n", {expr});')
    for name, value in nvml.CONSTANTS.items():
        want[name] = value
        lines.append(f'printf("{name} %lld\\n", (long long)({name}));')
    src = ("#include <stddef.h>\n#include <stdio.h>\n#include <nvml.h>\n"
           "int main(void) {\n  " + "\n  ".join(lines)
           + "\n  return 0;\n}\n")
    with tempfile.TemporaryDirectory() as d:
        c_path, exe = os.path.join(d, "probe.c"), os.path.join(d, "probe")
        with open(c_path, "w") as f:
            f.write(src)
        built = subprocess.run([cc, "-I", include, "-o", exe, c_path],
                               capture_output=True, text=True, timeout=120)
        if built.returncode != 0:
            fail(f"nvml: the nvml.h probe did not build: {built.stderr}")
        ran = subprocess.run([exe], capture_output=True, text=True,
                             timeout=60, check=True)
    got = {}
    for line in ran.stdout.splitlines():
        key, value = line.rsplit(" ", 1)
        got[key] = int(value)
    differ = {k: [v, got.get(k)] for k, v in want.items() if got.get(k) != v}
    if differ:
        fail(f"nvml: the binding differs from {header}: "
             f"{json.dumps(differ)} (binding, header)")
    return dict(header=header, checked=len(want), header_values=got)


def smi_read(uuid: str, fields) -> dict:
    """nvidia-smi's reading of the card `uuid`, numbers without units."""
    out = subprocess.run(
        ["nvidia-smi", "-i", uuid, f"--query-gpu={','.join(fields)}",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvml: nvidia-smi: {out.stderr}")
    return dict(zip(fields, (v.strip() for v in out.stdout.split(","))))


def under_load(step, probe, min_s: float = 0.0):
    """Runs `step` back to back on this thread until `probe` (on a second
    thread) has returned and `min_s` have passed; returns the probe's
    result, the steps run and the seconds."""
    done, box = threading.Event(), {}

    def run():
        try:
            box["out"] = probe()
        except BaseException as e:  # noqa: BLE001 — failed below (a
            box["err"] = e          # fail() in the probe exits no thread)
        finally:
            done.set()
    th = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    th.start()
    n = 0
    while not done.is_set() or time.perf_counter() - t0 < min_s:
        step()
        n += 1
        if n % 16 == 0:
            torch.cuda.synchronize()
        if time.perf_counter() - t0 > 120:
            fail("nvml: a load stretch ran past 120 s")
    torch.cuda.synchronize()
    th.join(10)
    if "err" in box:
        fail(f"nvml: {box['err']!r}")
    return box["out"], n, time.perf_counter() - t0


def parse_prometheus(text: str) -> tuple:
    """({family: type}, {(name, ((label, value), ...)): value})."""
    types, series = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            types[name] = kind
        elif line and not line.startswith("#"):
            m = _PROM_LINE.match(line)
            if m is None:
                raise ValueError(f"bad metrics line {line!r}")
            labels = tuple(sorted(_PROM_LABEL.findall(m.group(2) or "")))
            series[(m.group(1), labels)] = float(m.group(3))
    return types, series


def start_main(module: str, args: list):
    """A main of the port in its own process, once it printed its line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", module, *args],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, PYTHONUNBUFFERED="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines, up = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line)
            if " up on " in line:
                up.set()
        up.set()
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    if not up.wait(120) or proc.poll() is not None:
        stop_main(proc, reader)
        fail(f"nvml: {module} did not come up: {''.join(lines)[-2000:]}")
    return proc, reader, lines


def stop_main(proc, reader):
    """SIGTERM, then the exit code (None when it had to be killed)."""
    rc = None
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    reader.join(10)
    return rc


def median_host_ms(fn, n: int = NVML_HOST_READS) -> float:
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


class _Points:
    """An optimizer that keeps the agent's points."""

    def __init__(self):
        self.points = []

    def ingest_telemetry(self, point):
        self.points.append(point)


def run_nvml(dev, flash, kernels, card: str) -> dict:
    """The nvml phase (ROADMAP A13): the node's device layer on the card,
    with the launch counters set to 0 just before it and read just after.
    Its load is the port's flash forward at the trainer's shape, a test
    harness and no path of the port, so its launches are checked here
    against its steps and counted on no main path."""
    from k8s_gpu_workload_enhancer_tpu_torch.agent.agent import (
        AgentConfig, NodeAgent)
    from k8s_gpu_workload_enhancer_tpu_torch.discovery import nvml
    from k8s_gpu_workload_enhancer_tpu_torch.discovery.native_client import \
        NativeGPUClient
    gates, out = [], {"card": card}
    out["header_check"] = nvml_header_check(nvml)
    kernels.reset_launches()
    client = NativeGPUClient(NVML_NODE, "nvml")
    client.initialize()
    procs = []
    try:
        # Identity: NVML's device of torch's card, by UUID.
        want_uuid = f"GPU-{torch.cuda.get_device_properties(0).uuid}"
        with nvml.Session() as session:
            count = session.device_count()
            uuids = [session.uuid(session.handle(i)) for i in range(count)]
            if want_uuid not in uuids:
                fail(f"nvml: no NVML device has torch's UUID {want_uuid}")
            idx = uuids.index(want_uuid)
            handle = session.handle(idx)
            name = session.name(handle)
            limit_w = session.power_limit_mw(handle) / 1000.0
        chip = f"{NVML_NODE}-chip-{idx}"
        smi = smi_read(want_uuid, ("name", "power.limit", "memory.total"))
        out["identity"] = dict(nvml_index=idx, nvml_devices=count, name=name,
                               smi_name=smi["name"], power_limit_w=limit_w,
                               smi_power_limit_w=smi["power.limit"])
        if name != smi["name"]:
            gates.append(f"nvml: name {name!r}, nvidia-smi {smi['name']!r}")
        if abs(limit_w - float(smi["power.limit"])) > 0.005:
            gates.append(f"nvml: power limit {limit_w} W, nvidia-smi "
                         f"{smi['power.limit']} W")

        def read():
            sample, lost = client.samples()[idx]
            if lost or sample.health != 0:
                fail(f"nvml: {chip} health {sample.health} {lost}")
            return sample

        def temperature_pair():
            t = read().temperature_c
            return t, float(smi_read(want_uuid, ("temperature.gpu",))[
                "temperature.gpu"])

        # Idle, busy (sampled from a second thread), idle again.
        torch.cuda.synchronize()
        time.sleep(NVML_IDLE_WAIT_S)
        idle_before = read()
        b, s_len = TRAIN_BATCH, TRAIN_DIMS["seq_len"]
        h = TRAIN_DIMS["n_heads"]
        d = TRAIN_DIMS["d_model"] // h
        gen = torch.Generator(device=dev).manual_seed(30)
        q, k, v = (torch.randn(b, s_len, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(3))

        def step():
            flash.flash_attention(q, k, v, True)

        def sample_busy():
            rows, t0 = [], time.perf_counter()
            while (t := time.perf_counter() - t0) < NVML_LOAD_S:
                s = read()
                rows.append(dict(t_s=round(t, 3), duty=s.duty_cycle_pct,
                                 power_w=s.power_watts,
                                 temperature_c=s.temperature_c,
                                 hbm_used_gb=s.hbm_used_gb))
                time.sleep(NVML_SAMPLE_S)
            return rows
        rows, steps, seconds = under_load(step, sample_busy)
        load_steps = steps
        torch.cuda.synchronize()
        time.sleep(NVML_IDLE_WAIT_S)
        idle_after = read()
        busy = [r for r in rows if r["t_s"] >= NVML_WARM_S]
        duty = float(np.median([r["duty"] for r in busy]))
        power = float(np.median([r["power_w"] for r in busy]))
        idle_duty = max(idle_before.duty_cycle_pct, idle_after.duty_cycle_pct)
        out["load"] = dict(kernel="flash_attention", shape=[b, s_len, h, d],
                           dtype="bf16", steps=steps, seconds=seconds,
                           samples=rows)
        out["readings"] = dict(
            idle_before=dataclasses.asdict(idle_before),
            idle_after=dataclasses.asdict(idle_after),
            busy_duty_p50=duty, busy_power_w_p50=power,
            busy_power_w_max=max(r["power_w"] for r in busy))
        if not (duty >= NVML_BUSY_MIN_PCT and duty > idle_duty):
            gates.append(f"nvml: busy duty cycle {duty} %, want >= "
                         f"{NVML_BUSY_MIN_PCT} and above idle {idle_duty}")
        for what, w in (("idle", idle_after.power_watts), ("busy p50", power)):
            if not 0 < w <= limit_w:
                gates.append(f"nvml: {what} power {w} W not in (0, "
                             f"{limit_w}]")
        total_mib = idle_after.hbm_total_gb * 1024.0
        if abs(total_mib - float(smi["memory.total"])) > NVML_TOTAL_TOL_MIB:
            gates.append(f"nvml: hbm_total {total_mib} MiB, nvidia-smi "
                         f"{smi['memory.total']} MiB")
        t_nvml, t_smi = temperature_pair()
        out["readings"].update(temperature_c=t_nvml, smi_temperature_c=t_smi,
                               hbm_total_mib=total_mib,
                               smi_memory_total_mib=smi["memory.total"])
        if abs(t_nvml - t_smi) > NVML_TEMP_TOL_C:
            gates.append(f"nvml: temperature {t_nvml} C, nvidia-smi {t_smi}")

        # Device memory: the used delta of an allocation against the
        # allocator's reserved delta; and which `used` nvidia-smi prints.
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        r0, u0 = torch.cuda.memory_reserved(dev), read().hbm_used_gb
        buf = torch.empty(NVML_ALLOC_GIB << 30, dtype=torch.uint8, device=dev)
        buf.fill_(1)
        torch.cuda.synchronize()
        r1, u1 = torch.cuda.memory_reserved(dev), read().hbm_used_gb
        smi_mem = smi_read(want_uuid, ("memory.used", "memory.reserved"))
        u_now = read().hbm_used_gb
        del buf
        torch.cuda.empty_cache()
        d_nvml, d_torch = u1 - u0, (r1 - r0) / float(1 << 30)
        out["memory"] = dict(
            allocated_gib=NVML_ALLOC_GIB, nvml_used_delta_gib=d_nvml,
            reserved_delta_gib=d_torch, nvml_used_mib=u_now * 1024.0,
            smi_used_mib=smi_mem["memory.used"],
            smi_reserved_mib=smi_mem["memory.reserved"])
        if abs(d_nvml - d_torch) > NVML_MEM_TOL_GIB:
            gates.append(f"nvml: hbm_used delta {d_nvml} GiB, reserved "
                         f"delta {d_torch} GiB")

        # The mains: the agent with auto must choose nvml; the agent's
        # telemetry and the exporter's families under the load.
        aport = free_port()
        agent_proc = start_main(
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.agent",
            ["--node-name", NVML_NODE, "--shim-source", "auto", "--port",
             str(aport), "--telemetry-interval", "0.5"])
        procs.append(agent_proc)
        exporter_proc = start_main(
            "k8s_gpu_workload_enhancer_tpu_torch.cmd.exporter",
            ["--shim-source", "nvml", "--node-name", NVML_NODE, "--port",
             "0", "--collect-interval", "0.25"])
        procs.append(exporter_proc)
        eport = int(next(x for x in exporter_proc[2] if " up on :" in x)
                    .split(" up on :")[1].split()[0])
        code, health = get_json(aport, "/health")
        out["agent_health"] = health
        if code != 200 or health.get("shim_source") != "nvml":
            fail(f"nvml: the agent main with --shim-source auto chose "
                 f"{health.get('shim_source')!r}, want 'nvml' ({code})")
        labels = (("chip", chip), ("node", NVML_NODE))

        def scrape_exporter():
            with urllib.request.urlopen(f"http://127.0.0.1:{eport}/metrics",
                                        timeout=30) as r:
                types, series = parse_prometheus(r.read().decode())
            row = {name: series.get((name, labels)) for name in (
                "ktwe_chip_duty_cycle_percent",
                "ktwe_chip_tensorcore_utilization_percent",
                "ktwe_chip_hbm_used_gb", "ktwe_chip_hbm_total_gb",
                "ktwe_chip_power_watts", "ktwe_chip_temperature_celsius",
                "ktwe_chip_healthy")}
            row["ktwe_cluster_chips_total{state=healthy}"] = series.get(
                ("ktwe_cluster_chips_total", (("state", "healthy"),)))
            return types, row

        def probe_mains():
            code, r = post_json(aport, "/v1/assign", {
                "workloadUid": "smoke-load", "chipIds": [chip]})
            if code != 200:
                raise RuntimeError(f"/v1/assign answered {code} {r}")
            t0, tel = time.perf_counter(), None
            while time.perf_counter() - t0 < 30:
                tel = get_json(aport, "/v1/telemetry")[1]
                w = tel["workloads"].get("smoke-load")
                if w and w["duty_cycle_pct"] > 0:
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError(f"the agent never showed the load: {tel}")
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 30:
                types, row = scrape_exporter()
                if (row["ktwe_chip_duty_cycle_percent"] or 0) > 0:
                    break
                time.sleep(0.25)
            else:
                raise RuntimeError("the exporter never showed the load")
            # The load steady, each scrape beside the client's own read.
            time.sleep(NVML_WARM_S)
            pairs = []
            for _ in range(NVML_PAIRS):
                types, row = scrape_exporter()
                pairs.append((row, read()))
                time.sleep(NVML_SAMPLE_S)
            return tel, types, pairs
        (tel, types, pairs), steps, _ = under_load(step, probe_mains)
        load_steps += steps
        busy_row = pairs[-1][0]
        # The tolerances on an idle scrape: at a load's start the card's
        # power reading overshoots its limit before the cap holds it.
        torch.cuda.synchronize()
        time.sleep(NVML_IDLE_WAIT_S)
        idle_types, row = scrape_exporter()
        near, temps = read(), temperature_pair()
        out["agent_telemetry"] = tel
        for what, r, ts in [("busy", p[0], types) for p in pairs] + [
                ("idle", row, idle_types)]:
            if any(v is None for v in r.values()) or any(
                    ts.get(n.split("{")[0]) != "gauge" for n in r):
                fail(f"nvml: the exporter's {what} families for {chip}: "
                     f"{r}, types {ts}")
        apart = {
            key: float(np.median([abs(r[family] - getattr(s, field))
                                  for r, s in pairs]))
            for key, family, field in (
                ("duty_pts", "ktwe_chip_duty_cycle_percent",
                 "duty_cycle_pct"),
                ("power_w", "ktwe_chip_power_watts", "power_watts"),
                ("hbm_used_gib", "ktwe_chip_hbm_used_gb", "hbm_used_gb"),
                ("temperature_c", "ktwe_chip_temperature_celsius",
                 "temperature_c"))}
        out["exporter"] = dict(
            busy=busy_row, idle=row, types=types, busy_apart_p50=apart,
            busy_pairs=[dict(exporter=r, client=dataclasses.asdict(s))
                        for r, s in pairs])
        checks = {
            "busy duty > 0": busy_row["ktwe_chip_duty_cycle_percent"] > 0,
            "busy power > 0": busy_row["ktwe_chip_power_watts"] > 0,
            "busy healthy": all(r["ktwe_chip_healthy"] == 1
                                for r, _ in pairs),
            "busy duty near the client's":
                apart["duty_pts"] <= NVML_PAIR_DUTY_PTS,
            "busy power near the client's":
                apart["power_w"] <= NVML_PAIR_POWER_FRAC * limit_w,
            "busy hbm_used near the client's":
                apart["hbm_used_gib"] <= NVML_MEM_TOL_GIB,
            "busy temperature near the client's":
                apart["temperature_c"] <= NVML_TEMP_TOL_C,
            "tensorcore 0":
                all(r["ktwe_chip_tensorcore_utilization_percent"] == 0
                    for r, _ in pairs)
                and row["ktwe_chip_tensorcore_utilization_percent"] == 0,
            "hbm_used near the client's":
                abs(row["ktwe_chip_hbm_used_gb"] - near.hbm_used_gb)
                <= NVML_MEM_TOL_GIB,
            "hbm_total": abs(row["ktwe_chip_hbm_total_gb"] * 1024.0
                             - float(smi["memory.total"]))
            <= NVML_TOTAL_TOL_MIB,
            "power": 0 < row["ktwe_chip_power_watts"] <= limit_w,
            "temperature": abs(row["ktwe_chip_temperature_celsius"]
                               - temps[1]) <= NVML_TEMP_TOL_C,
            "healthy": row["ktwe_chip_healthy"] == 1,
            "cluster healthy":
                row["ktwe_cluster_chips_total{state=healthy}"] >= 1}
        for what, ok in checks.items():
            if not ok:
                gates.append(f"nvml: exporter {what}: {out['exporter']}")
        out["mains_exit"] = [stop_main(p, r) for p, r, _ in procs]
        procs.clear()
        if out["mains_exit"] != [0, 0]:
            gates.append(f"nvml: the mains exited {out['mains_exit']}")

        # Host cost of a read and of one agent pass, card idle.
        agent = NodeAgent(client, AgentConfig(node_name=NVML_NODE),
                          optimizer_service=_Points())
        agent.assign_chips("smoke-load", [chip])
        out["host_ms"] = dict(
            client_read_all_p50=median_host_ms(client.samples),
            collect_and_push_p50=median_host_ms(agent.collect_and_push),
            reads=NVML_HOST_READS, devices=count)
    finally:
        for p, r, _ in procs:
            stop_main(p, r)
        client.shutdown()
    # The load's launches, and nothing else: the agent and the exporter
    # launch no kernel.
    out["launches"] = dict(kernels.launches)
    want = {flash.KERNEL: load_steps, flash.KERNEL_WGMMA: load_steps}
    if load_steps <= 0 or out["launches"] != want:
        gates.append(f"nvml: launches {out['launches']}, its {load_steps} "
                     f"load steps need {want}")
    out["gates_failed"] = gates
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import serve
    from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as trainer_cli
    from k8s_gpu_workload_enhancer_tpu_torch.models import (
        decode, serving, transformer as tf)
    from k8s_gpu_workload_enhancer_tpu_torch.ops import (
        attention as attn_mod, embed, flash_attention as flash, fused_ce,
        kernels, paged_attention as paged, relayout, rms, rope)
    from k8s_gpu_workload_enhancer_tpu_torch.parallel import (
        pipeline, ring_attention as ring)
    from k8s_gpu_workload_enhancer_tpu_torch.sharing import tenant_drain
    from k8s_gpu_workload_enhancer_tpu_torch.train import (
        checkpoint, data, flagship, profiling, trainer)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr}")
    card = smi.stdout.strip()
    for line in card.splitlines():
        print(line.strip(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    # Every f32 product in full f32 (the plain versions' references).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    per_lib = kernels.build()
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "per_library_s": per_lib}), flush=True)
    for name in kernels.SIGNATURES:
        for line in kernels.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    regs = {k: int(re.search(rf"{k} = (\d+);", src).group(1))
            for k in ("kProducerRegs", "kConsumerRegs")}
    print(json.dumps({"flash_attention_build": {
        "build_s": per_lib["flash_attention"],
        "kernels": ptxas_entries(kernels.build_log("flash_attention")),
        "setmaxnreg": regs,
        "bodies": [dict(dtype=str(dt).split(".")[-1], d=d,
                        **flash_body(flash, dt, d))
                   for dt, d in ((torch.bfloat16, 128),
                                 (torch.bfloat16, 512),
                                 (torch.float32, 512))]}}), flush=True)

    print(json.dumps({"flash_attention_bwd_build": {
        "build_s": per_lib["flash_attention_bwd"],
        "kernels": ptxas_entries(kernels.build_log("flash_attention_bwd")),
        "bodies": [dict(kernel=k, dtype=str(dt).split(".")[-1], d=d,
                        **flash.bwd_body(k, d, dt))
                   for k in (flash.KERNEL_BWD_DQ, flash.KERNEL_BWD_DKV,
                             flash.KERNEL_BWD_DKV_STASH)
                   for dt, d in ((torch.bfloat16, 128), (torch.bfloat16, 512),
                                 (torch.float32, 128))]}}), flush=True)
    print(json.dumps({"rms_build": {
        "build_s": per_lib["rms"],
        "kernels": ptxas_entries(kernels.build_log("rms"))}}), flush=True)
    print(json.dumps({"paged_decode_build": {
        "build_s": per_lib["paged_decode"],
        "kernels": ptxas_entries(kernels.build_log("paged_decode"))}}),
        flush=True)
    print(json.dumps({"fused_ce_build": {
        "build_s": per_lib["fused_ce"],
        "kernels": ptxas_entries(kernels.build_log("fused_ce")),
        "setmaxnreg": {k: int(re.search(rf"{k} = (\d+);", (
            kernels.CSRC / "fused_ce.cu").read_text()).group(1))
            for k in ("kProducerRegs", "kConsumerRegs")},
        "bodies": [dict(kernel=k, dtype=str(dt).split(".")[-1],
                        **fused_ce.body_report(k, dt))
                   for k in (fused_ce.KERNEL_FWD, fused_ce.KERNEL_BWD)
                   for dt in (torch.bfloat16, torch.float32)]}}), flush=True)
    results = {"kernels": check_kernels(dev, rms, rope, flash, paged,
                                        attn_mod),
               "launch_floor_ms": launch_floor_ms(dev)}
    check_train_kernels(dev, rms, rope, flash, attn_mod, results["kernels"])
    check_flagship_kernels(dev, rope, fused_ce, attn_mod, results["kernels"])
    check_embed_relayout_kernels(dev, embed, relayout, results["kernels"])
    print(json.dumps({"kernel_checks": results["kernels"]}), flush=True)
    print(json.dumps({"off_path_checks": check_off_path_shapes(dev, rms, flash)}),
          flush=True)
    results["ring"] = run_ring(dev, flash, ring, kernels, card)
    print(json.dumps({"ring": results["ring"]}), flush=True)
    results["ep"] = run_ep(dev, tf, embed, attn_mod, flash, kernels, card)
    print(json.dumps({"ep": results["ep"]}), flush=True)
    for gate in results["ep"]["gates_failed"]:
        fail(gate)
    results["pp"] = run_pp(dev, tf, pipeline, attn_mod, flash, kernels, card)
    print(json.dumps({"pp": results["pp"]}), flush=True)
    results["ring_gathered"] = results["ring"]["gathered"]
    results["pp_tp"] = results["pp"]["gpipe_tp"]
    for gate in results["pp"]["gates_failed"]:
        fail(gate)
    mods = (kernels, rms, rope, flash, paged, tf, decode, serving, serve)
    cfg, params, init_s = serve_params(dev, tf, serve)
    n_layers = SERVE_DIMS["n_layers"]
    # The main paths; each phase sets the launch counters to 0 just before
    # it and reads them just after.
    results["engine"] = run_engine(dev, mods, cfg, params, init_s)
    print(json.dumps({"engine": results["engine"]}), flush=True)
    print(json.dumps({"hotpath": dict(engine="dense", card=card,
                                      **results["engine"]["hotpath"])}),
          flush=True)
    results["serve"] = run_serve(serve, kernels)
    print(json.dumps({"serve": results["serve"]}), flush=True)
    results["paged_engine"] = run_paged_engine(dev, mods, cfg, params)
    print(json.dumps({"paged_engine": results["paged_engine"]}), flush=True)
    print(json.dumps({"hotpath": dict(engine="paged", card=card,
                                      **results["paged_engine"]["hotpath"])}),
          flush=True)
    print(json.dumps({"serving_profile": profile_serving(dev, mods, cfg,
                                                         params)}),
          flush=True)
    results["tenancy"] = run_tenancy(dev, mods, cfg, params)
    print(json.dumps({"tenancy": dict(card=card, **results["tenancy"])}),
          flush=True)
    results["disagg"] = run_disagg(dev, mods, cfg, params)
    print(json.dumps({"disagg": dict(card=card, **results["disagg"])}),
          flush=True)
    for gate in results["disagg"]["gates_failed"]:
        fail(gate)
    results["int8kv"] = run_int8kv(dev, mods, cfg, params, card)
    print(json.dumps({"int8kv": dict(card=card, **results["int8kv"])}),
          flush=True)
    for gate in results["int8kv"]["gates_failed"]:
        fail(gate)
    results["spec"] = run_spec(dev, mods, cfg, params, card)
    print(json.dumps({"spec": results["spec"]}), flush=True)
    for gate in results["spec"]["gates_failed"]:
        fail(gate)
    results["kvhost"] = run_kvhost(dev, mods, cfg, params, card)
    print(json.dumps({"kvhost": results["kvhost"]}), flush=True)
    for gate in results["kvhost"]["gates_failed"]:
        fail(gate)
    moe_out = run_moe_engines(dev, mods, params, card)
    results["moe_engine"], results["moe_paged_engine"] = (moe_out["dense"],
                                                          moe_out["paged"])
    print(json.dumps({"moe_engines": moe_out}), flush=True)
    for gate in moe_out["gates_failed"]:
        fail(gate)
    results["census"] = run_census(dev, mods, card)
    print(json.dumps({"census": results["census"]}), flush=True)
    del params
    torch.cuda.empty_cache()
    results["mesh"] = run_mesh(dev, mods, card)
    print(json.dumps({"mesh": results["mesh"]}), flush=True)
    print(json.dumps({"icibench": results["mesh"]["icibench"]}),
          flush=True)
    for gate in results["mesh"]["gates_failed"]:
        fail(gate)
    results["paged_serve"] = run_serve(serve, kernels, paged=True)
    print(json.dumps({"paged_serve": results["paged_serve"]}), flush=True)
    for phase in ("serve", "paged_serve"):
        got = results[phase]["launches"]
        want = expected_launches(n_layers, results[phase]["lifetime"],
                                 paged=phase == "paged_serve")
        if got != want:
            fail(f"{phase} launches {got}, its chunks and steps need {want}")
    ckpt_out = run_checkpoint(dev, kernels, trainer_cli, serve, tf, trainer,
                              checkpoint, data)
    results["checkpoint_train"] = {"launches": ckpt_out["train_launches"]}
    results["checkpoint_serve"] = ckpt_out["serve"]
    results["checkpoint_paged_serve"] = ckpt_out["paged_serve"]
    print(json.dumps({"checkpoint": dict(card=card, **ckpt_out)}),
          flush=True)
    results["fleet"] = run_fleet(serve, kernels)
    results["fleet_paged"] = run_fleet(serve, kernels, paged=True)
    summary = {}
    for name, phase, ck in (("dense", "fleet", "serve"),
                            ("paged", "fleet_paged", "paged_serve")):
        f = results[phase]
        summary[name] = dict(
            ttft_p50_ms_prefix=f["prefix"]["ttft_p50_ms_prefix"],
            ttft_p50_ms_full_prompt=f["prefix"]["ttft_p50_ms_full"],
            prefill_chunks_saved=f["prefix"]["prefill_chunks_saved"],
            eject_ms=f["migration"]["eject_ms"],
            ttft_p50_ms_resumed=float(np.median(
                f["migration"]["ttft_ms_resumed"])),
            ttft_p50_ms_fresh=float(np.median(
                f["migration"]["ttft_ms_fresh"])),
            swap_pause_ms_with_prefix=ckpt_out[ck][
                "swap_pause_ms_with_prefix"],
            swap_pause_ms_without=ckpt_out[ck]["swap_pause_ms"])
    print(json.dumps({"fleet": dict(card=card, summary=summary,
                                    dense=results["fleet"],
                                    paged=results["fleet_paged"])}),
          flush=True)
    results["observability"] = run_observability(serve, kernels, card)
    print(json.dumps({"observability": results["observability"]}),
          flush=True)
    for gate in results["observability"]["gates_failed"]:
        fail(gate)
    gate_mods = (kernels, rms, rope, flash, tf, trainer)
    results["train_gate_f32"] = run_train_gate(dev, gate_mods)
    print(json.dumps({"train_gate_f32": results["train_gate_f32"]}),
          flush=True)
    results["flagship_gate_f32"] = run_train_gate(
        dev, gate_mods, FLAGSHIP_GATE_DIMS, FLAGSHIP_GATE_BATCH, flagship=True)
    print(json.dumps({"flagship_gate_f32": results["flagship_gate_f32"]}),
          flush=True)
    for route in ("ragged", "dense"):
        results[f"moe_gate_f32_{route}"] = run_train_gate(
            dev, gate_mods, dict(MOE_GATE_DIMS,
                                 moe_ragged_dispatch=route == "ragged"))
    print(json.dumps({"moe_gate_f32": dict(card=card, **{
        route: results[f"moe_gate_f32_{route}"]
        for route in ("ragged", "dense")})}), flush=True)
    results["train"] = run_trainer(trainer_cli, kernels, TRAIN_BATCH,
                                   TRAIN_STEPS, stash=False)
    print(json.dumps({"train": results["train"]}), flush=True)
    results["fsdp"] = run_fsdp(trainer_cli, kernels, tf, results["train"],
                               card)
    print(json.dumps({"fsdp": results["fsdp"]}), flush=True)
    results["tenant_drain"] = run_tenant_drain(kernels, tf, trainer,
                                               tenant_drain, card)
    print(json.dumps({"tenant_drain": results["tenant_drain"]}), flush=True)
    results["train_stash"] = run_trainer(trainer_cli, kernels, STASH_BATCH,
                                         STASH_STEPS, stash=True)
    print(json.dumps({"train_stash": results["train_stash"]}), flush=True)
    results["moe_train"] = run_trainer(trainer_cli, kernels, TRAIN_BATCH,
                                       MOE_TRAIN_STEPS, stash=False,
                                       experts=MOE_EXPERTS)
    results["moe_train"].update(card=card, params=moe_param_count(
        tf, dict({k: v for k, v in TRAIN_DIMS.items() if k != "seq_len"},
                 n_kv_heads=TRAIN_DIMS["n_heads"], n_experts=MOE_EXPERTS)))
    print(json.dumps({"moe_train": results["moe_train"]}), flush=True)
    results["flagship"] = run_flagship(kernels, trainer, flagship)
    print(json.dumps({"flagship": results["flagship"]}), flush=True)
    results["profile"] = profile_steps(trainer_cli, trainer, flagship)
    print(json.dumps({"profile": results["profile"]}), flush=True)
    results["trace"] = run_trace(dev, tf, trainer, profiling, card)
    print(json.dumps({"trace": results["trace"]}), flush=True)
    results["nvml"] = run_nvml(dev, flash, kernels, card)
    print(json.dumps({"nvml": results["nvml"]}), flush=True)
    for gate in results["nvml"]["gates_failed"]:
        fail(gate)

    serving_phases = ("engine", "serve", "paged_engine", "paged_serve",
                      "tenancy", "disagg", "int8kv", "spec", "kvhost",
                      "checkpoint_serve", "checkpoint_paged_serve", "fleet",
                      "fleet_paged", "observability", "moe_engine",
                      "moe_paged_engine", "mesh")
    train_phases = ("train", "fsdp", "train_stash", "moe_train")
    paged_phases = ("paged_engine", "paged_serve", "tenancy", "disagg",
                    "spec", "kvhost", "checkpoint_paged_serve",
                    "fleet_paged", "observability", "moe_paged_engine",
                    "mesh")
    # The checkpoint phase's trainer runs the t-layout path (head_dim 512).
    t_layout = ("flagship", "checkpoint_train")
    every = serving_phases + train_phases
    paths = {"embed_gather": every + t_layout + ("ep", "pp"),
             "rms_norm": every + t_layout + ("ep", "pp", "pp_tp"),
             "rope": every + ("ep", "pp", "pp_tp"),
             "flash_attention": every + t_layout
             + ("ring", "ring_gathered", "ep", "pp", "pp_tp"),
             "paged_decode": paged_phases,
             "paged_decode_combine": paged_phases,
             "rms_norm_bwd": train_phases + t_layout + ("ep", "pp", "pp_tp"),
             "flash_attention_bwd_dq": train_phases + t_layout
             + ("ring", "ring_gathered", "ep", "pp", "pp_tp"),
             "flash_attention_bwd_dkv": ("train", "fsdp", "moe_train", "pp",
                                         "ring_gathered"),
             "flash_attention_bwd_dkv_stash": ("train_stash",) + t_layout
             + ("ring", "ring_gathered", "ep", "pp", "pp_tp"),
             "rope_t": t_layout, "rope_t_inv": t_layout,
             "fused_ce_fwd": ("flagship",), "fused_ce_bwd": ("flagship",),
             "relayout_to_t": t_layout, "relayout_from_t": t_layout}
    # Every bf16 flash and fused CE launch of every phase ran a tensor-core
    # body: the flash forward, dQ and the stash dK/dV at every head_dim, the
    # recompute dK/dV of the train phase (head_dim 128), the fused CE
    # forward and backward of the flagship; none in the f32 gates.
    bodies = {}
    for kernel, counter in WGMMA_COUNTERS.items():
        for phase in paths[kernel]:
            n = results[phase]["launches"]
            got = [n.get(counter, 0), n.get(kernel, 0)]
            bodies[f"{phase}/{kernel}"] = got
            if got[0] != got[1]:
                fail(f"{phase}: {got[0]} of {got[1]} {kernel} launches ran "
                     f"the wgmma body, want all")
    for gate in ("train_gate_f32", "flagship_gate_f32",
                 "moe_gate_f32_ragged", "moe_gate_f32_dense"):
        for path in ("stash", "recompute"):
            n = results[gate][path]["launches"]
            for kernel, counter in WGMMA_COUNTERS.items():
                bodies[f"{gate}/{path}/{kernel}"] = [n.get(counter, 0),
                                                     n.get(kernel, 0)]
                if n.get(counter, 0):
                    fail(f"{gate} ({path}) ran the bf16 wgmma body of "
                         f"{kernel}")
    print(json.dumps({"bodies_wgmma_of_all": bodies}), flush=True)
    main_path_launches = {}
    for name, on in paths.items():
        for phase in on:
            n = results[phase]["launches"].get(name, 0)
            if n <= 0:
                fail(f"kernel {name} never launched in the {phase} phase")
            main_path_launches[name] = main_path_launches.get(name, 0) + n
    entries = []
    port, ref = ("k8s_gpu_workload_enhancer_tpu_torch/csrc/",
                 "k8s_gpu_workload_enhancer_tpu/ops/")
    meta = {
        "rms_norm": ("rms.cu", "rms_pallas.py:41"),
        "rope": ("rope.cu", "rope_pallas.py:30"),
        "flash_attention": ("flash_attention.cu", "flash_attention.py:125"),
        "paged_decode": ("paged_decode.cu", "flash_attention.py:809"),
        "paged_decode_combine": ("paged_decode.cu", "flash_attention.py:809"),
        "rms_norm_bwd": ("rms.cu", "rms_pallas.py:48"),
        "flash_attention_bwd_dq": ("flash_attention_bwd.cu",
                                   "flash_attention.py:299"),
        "flash_attention_bwd_dkv_stash": ("flash_attention_bwd.cu",
                                          "flash_attention.py:377"),
        "flash_attention_bwd_dkv": ("flash_attention_bwd.cu",
                                    "flash_attention.py:418"),
        "rope_t": ("rope.cu", "rope_pallas.py:111"),
        "rope_t_inv": ("rope.cu", "rope_pallas.py:121"),
        "fused_ce_fwd": ("fused_ce.cu", "fused_ce.py:87"),
        "fused_ce_bwd": ("fused_ce.cu", "fused_ce.py:175"),
        "embed_gather": ("embed.cu", "embed_pallas.py:61"),
        "relayout_to_t": ("relayout.cu", "relayout.py:56"),
        "relayout_from_t": ("relayout.cu", "relayout.py:63"),
    }
    fwd_tol = {"atol": BF16_ATOL, "rtol": BF16_RTOL}
    bwd_tol = {"rtol": {str(k).split(".")[-1]: v for k, v in BWD_RTOL.items()},
               "atol_of_rms": {str(k).split(".")[-1]: v
                               for k, v in BWD_ATOL_OF_RMS.items()}}
    ce_tol = {"fused_ce_fwd": {"lse_gold_rtol": {
                  str(k).split(".")[-1]: v for k, v in CE_STAT_RTOL.items()},
                  "stash": "one bf16 ulp"},
              "fused_ce_bwd": {"dlg": "one bf16 ulp", "dh": bwd_tol}}
    for name, (source, replaces) in meta.items():
        cases = results["kernels"][name]
        main = cases[0]     # the path's own shape: prefill chunk, decode
        extra = {k: main[k] for k in ("dense_sdpa_ms", "eager_ms",  # step,
                                      "eager_is", "library_is")  # train step
                 if k in main}
        if name in WGMMA_COUNTERS:
            extra["wgmma_launches"] = sum(
                results[phase]["launches"].get(WGMMA_COUNTERS[name], 0)
                for phase in paths[name])
        for k in ("body", "instance", "dynamic_smem_bytes",
                  "main_path_rotation"):
            if k in main:
                extra[k] = main[k]
        exact = name.startswith(("rope", "embed", "relayout"))
        tolerance = (ce_tol[name] if name in ce_tol else
                     {"forward": "bit for bit", "vjp": "bit for bit"}
                     if name == "rope" else
                     {"forward": "bit for bit"} if exact
                     else {"backward": bwd_tol} if "bwd" in name else
                     {"forward": fwd_tol})
        entries.append(dict(
            name=name, route="cuda", source=port + source,
            replaces=ref + replaces, launches=main_path_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            tolerance=tolerance, ms=main["ms"],
            wrapper_ms=main["wrapper_ms"], plain_ms=main["plain_ms"],
            bound_ms=main["bound_ms"], bound_by=main["bound_by"],
            library_ms=main["library_ms"], **extra, shape=main["shape"],
            cases=cases))
    print(json.dumps({"kernels": entries,
                      "launch_floor_ms": results["launch_floor_ms"]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
