"""GPipe pipeline parallelism over the ``pp`` mesh axis.

Port of k8s_gpu_workload_enhancer_tpu/parallel/pipeline.py, with its names
and contracts: `num_ticks`, `bubble_fraction`, `stack_stage_fn`, `gpipe`,
`transformer_stage_fn` and `gpipe_lm_loss`. Where JAX takes a mesh the
port takes a layout (parallel/sharding.Fsdp on a DeviceMesh, or
`StageLayout` over a thread gang's `Comm`): its `pp`, `pp_rank` and
`pp_comm`.

Schedule (GPipe, M microbatches, P stages, T = M + P - 1 ticks):

    tick t: stage r processes microbatch (t - r) if 0 <= t - r < M.
    Stage 0 reads the input xs; stage r > 0 the activation stage r - 1
    handed off; the last stage's outputs are the result, on every pp
    rank (JAX's psum of the outputs masked to the last stage).

The port runs the schedule as the stages' handoffs: stage r sends
microbatch m's activation to stage r + 1 (`Comm.send`, one p2p call of
one microbatch's activation, parallel/comm.py) as soon as it has it, and
stage r + 1 takes it (`Comm.recv`), so stage r runs m at tick m + r. JAX
runs the stage on every tick, the inactive ones on garbage inputs masked
out of the result, and its ppermute wraps the last stage round to the
first; the port runs neither, and the function is the same. Each stage's
weights are its (L/pp, ...) block of the stacked layer leaves, the
``layers`` -> ``pp`` rule of parallel/sharding.py.

The backward is GPipe's, in reverse: the last stage's cotangent comes
from the result's, each stage hands its input's cotangent to the stage
before it, and stage 0's is the cotangent of xs. Two forms, by the
layout's `Comm`:

- processes (`ProcessComm`: gloo on the CPU, NCCL on the card): the
  schedule is one autograd node a rank (`_GPipe`). Its forward runs the
  stage on each microbatch under a graph of its own (the input detached);
  its backward runs those graphs in reverse order of the microbatches,
  each with the cotangent received from the next stage, and sends the
  input's cotangent to the previous one. Each rank's autograd engine
  blocks in its own node, and every rank sends and receives in the same
  microbatch order, so the pairs match.
- a gang of threads (`ThreadComm`, a card's virtual ranks): a received
  tensor is the sender's own, so the stages' graphs join into one graph
  and the schedule's backward is part of the one backward the gang runs,
  from one thread, over its ranks' losses. No backward node then waits on
  another rank (on a CUDA device every backward node runs on one thread,
  where such a wait would never end); the handoffs' cotangent moves are
  noted as the p2p calls of the process form.

The result on every pp rank: the last stage's outputs, broadcast to the
other stages, where the copy carries no autograd history. Every pp rank
computes the same function of it (the final norm, the head, the loss),
so the last stage's own cotangent is the whole one; in the process form
the other stages' copies still lead to their `_GPipe` node, so that each
rank's backward runs its part of the schedule.

`gpipe_lm_loss` is KTWE-LM's loss through the schedule. The embedding
(on stage 0 only: no other stage reads xs), the final norm and the LM
head run outside it, the stacked layers inside, through
`transformer_stage_fn`: the model's own single-device layer
(models/transformer._layer), so on the card the stages run the
hand-written kernels. JAX leaves Pallas out of its stage only because a
Pallas call cannot run under shard_map. Dense layers only, as in JAX: MoE
pipelines through the layer-stack form. The trainer (train/trainer.py
`make_train_step(loss_fn=...)`) drives it; after the backward the layout
finishes the gradients (`Fsdp.reduce_grads_`: the pp-replicated leaves
are pp rank 0's, so stage 0's embedding gradient and the head's, the same
on every stage).

On a mesh with tp or sp above 1 the schedule runs as JAX's: its
`param_specs` name only pp and its `xs_spec` only the batch axes, so the
stage is replicated over tp and sp. Every tp and sp rank runs the whole
stage (`stage_params` gathers it over tp; whole heads, whole MLP, whole
sequences) on the rows of its batch coordinate, so the stage's RMSNorm,
RoPE and flash kernels run at full width. The embedding, head and CE stay
vocab-parallel as JAX's constrained versions are (the table's vocab rows
and the logits' vocab columns over tp: the model-parallel forward's
`_embed_vocab_parallel` and `_vocab_parallel_xent`), so no rank holds a
whole vocab leaf; every tp and sp rank's gradient is then the whole one
(`Fsdp.reduce_grads_` leaves out the sp average and the KV tp sum).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

StageFn = Callable[[Dict[str, torch.Tensor], torch.Tensor], torch.Tensor]


def num_ticks(num_microbatches: int, num_stages: int) -> int:
    return num_microbatches + num_stages - 1


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    """Idle fraction of the GPipe schedule: of T = M + P - 1 ticks each
    stage runs, only M carry a real microbatch -> (P-1)/T."""
    t = num_ticks(num_microbatches, num_stages)
    return (num_stages - 1) / t


def stack_stage_fn(layer_fn: Callable[[torch.Tensor, Dict[str, Any]],
                                      torch.Tensor]) -> StageFn:
    """Lift a per-layer fn (x, layer_params) -> x into a stage fn that runs
    the stage's local (L/pp, ...) stacked params, layer after layer."""

    def stage(params: Dict[str, torch.Tensor], x: torch.Tensor
              ) -> torch.Tensor:
        n = next(iter(params.values())).shape[0]
        for i in range(n):
            x = layer_fn(x, {k: v[i] for k, v in params.items()})
        return x

    return stage


def _pp(layout) -> int:
    return 1 if layout is None else getattr(layout, "pp", 1)


class _GPipe(torch.autograd.Function):
    """One rank's part of the schedule over processes (see the module
    note). Output: the stacked outputs (M, mb, ...) on the last stage, an
    empty tensor elsewhere."""

    @staticmethod
    def forward(ctx, stage_fn: StageFn, comm, names, xs: torch.Tensor,
                *params: torch.Tensor):
        r, last = comm.rank, comm.size - 1
        xs_grad, *wants = ctx.needs_input_grad[3:]
        leaves = [p.detach().requires_grad_(w) for p, w in zip(params, wants)]
        tree = dict(zip(names, leaves))
        ins, outs = [], []
        with torch.enable_grad():
            for i in range(xs.shape[0]):
                x = xs[i] if r == 0 else comm.recv(xs[0], r - 1)
                x = x.detach().requires_grad_(r > 0 or xs_grad)
                y = stage_fn(tree, x)
                if r < last:
                    comm.send(y.detach(), r + 1)
                ins.append(x)
                outs.append(y)
        ctx.comm, ctx.graphs, ctx.leaves = comm, (ins, outs), leaves
        ctx.xs_grad = xs_grad
        if r == last:
            return torch.stack([y.detach() for y in outs])
        return xs.new_empty(0)

    @staticmethod
    def backward(ctx, dys: torch.Tensor):
        comm, (ins, outs), leaves = ctx.comm, ctx.graphs, ctx.leaves
        r, last = comm.rank, comm.size - 1
        ctx.graphs = None
        grads = [None] * len(leaves)
        dxs = [None] * len(ins)
        wanted = [i for i, p in enumerate(leaves) if p.requires_grad]
        for i in reversed(range(len(ins))):
            g = dys[i] if r == last else comm.recv(outs[i], r + 1)
            x = [ins[i]] if ins[i].requires_grad else []
            got = torch.autograd.grad(
                outs[i], x + [leaves[j] for j in wanted], g,
                allow_unused=True)
            if x:
                if r > 0:
                    comm.send(got[0], r - 1)
                else:
                    dxs[i] = got[0]
            for j, gj in zip(wanted, got[len(x):]):
                if gj is not None:
                    grads[j] = gj if grads[j] is None else grads[j] + gj
            outs[i] = ins[i] = None
        dxs = torch.stack(dxs) if r == 0 and ctx.xs_grad else None
        return (None, None, None, dxs, *grads)


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every pp rank (a broadcast from it); the
    backward keeps the last stage's own cotangent and gives the other
    stages' `_GPipe` nodes an empty one (see the module note)."""

    @staticmethod
    def forward(ctx, ys: torch.Tensor, like: torch.Tensor, comm):
        last = comm.size - 1
        ctx.last, ctx.empty = comm.rank == last, ys.shape
        if ctx.last:
            comm.broadcast(ys, last)
            return ys.view_as(ys)
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        return comm.broadcast(out, last)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.last:
            return g, None, None
        return g.new_zeros(ctx.empty), None, None


def _gpipe_linked(stage_fn: StageFn, params, xs: torch.Tensor, comm
                  ) -> torch.Tensor:
    """The schedule on a gang of threads (see the module note)."""
    r, last = comm.rank, comm.size - 1
    outs = []
    for i in range(xs.shape[0]):
        x = xs[i] if r == 0 else comm.recv(xs[0], r - 1)
        y = stage_fn(params, x)
        if r < last:
            comm.send(y, r + 1)
        else:
            outs.append(y)
    if r == last:
        ys = torch.stack(outs)
        comm.broadcast(ys.detach(), last)
        return ys
    return comm.broadcast(torch.empty(xs.shape, dtype=xs.dtype,
                                      device=xs.device), last)


def gpipe(stage_fn: StageFn, stage_params: Dict[str, torch.Tensor],
          xs: torch.Tensor, layout=None) -> torch.Tensor:
    """Run microbatches through a pipeline of `layout.pp` stages.

    stage_fn(local_params, x_mb) -> y_mb applies one stage's layers to one
      microbatch and keeps the activation's shape; it sees this stage's
      `stage_params` (the leading layer axis divided by pp).
    xs: (M, mb, ...) microbatched input; read on stage 0 only (any tensor
      of that shape elsewhere).

    Returns (M, mb, ...) outputs, the last stage's, on every pp rank;
    differentiable (see the module note for the backward). At pp 1 (or
    `layout` None) it is the plain per-microbatch map, as JAX's vmap branch
    is. A layout's batch split is its caller's: each (dp, ep) coordinate
    pipelines its own rows (`batch_axes`)."""
    if _pp(layout) <= 1:
        return torch.stack([stage_fn(stage_params, x) for x in xs.unbind(0)])
    comm = layout.pp_comm
    if comm.shares_graph:
        return _gpipe_linked(stage_fn, stage_params, xs, comm)
    names = list(stage_params)
    ys = _GPipe.apply(stage_fn, comm, names, xs,
                      *[stage_params[k] for k in names])
    return _FromLast.apply(ys, xs, comm)


def transformer_stage_fn(cfg) -> StageFn:
    """KTWE-LM's decoder layer as a GPipe stage: the stage's local
    (L/pp, ...) stacked layer params, layer after layer, over a
    (mb, S, D) activation. The layer is the model's own single-device one
    (models/transformer._layer: RMSNorm, RoPE and flash attention on
    their kernels on the card, the lean SwiGLU), so the stack equals the
    model's forward (tests/test_torch_gpipe.py holds it to
    `tf.loss_fn`).

    Dense layers only: MoE's all-to-all dispatch spans the ep axis, which
    cuts across pipeline stages; MoE models pipeline through the
    layer-stack form (the "layers" axis on pp) instead."""
    from ..models import transformer as tf
    from ..ops.attention import rope_frequencies

    if cfg.is_moe:
        raise ValueError("explicit GPipe schedule supports dense layers; "
                         "MoE pipelines via layer-stack pp sharding")
    freqs: Dict[torch.device, torch.Tensor] = {}

    def layer(x: torch.Tensor, lp: Dict[str, torch.Tensor]) -> torch.Tensor:
        if x.device not in freqs:
            freqs[x.device] = rope_frequencies(cfg.head_dim, cfg.max_seq,
                                               cfg.rope_theta, x.device)
        return tf._layer(x, lp, cfg, freqs[x.device], 0)[0]

    return stack_stage_fn(layer)


def batch_axes(layout, microbatch: int) -> Optional[Tuple[str, ...]]:
    """The mesh axes a GPipe microbatch of `microbatch` global rows splits
    over, JAX's three cases: ("dp", "ep") where they divide it, else
    ("dp",) where dp does, else None (every rank pipelines the whole
    microbatch)."""
    dp = 1 if layout is None else layout.world
    ep = 1 if layout is None else layout.ep
    if microbatch % (dp * ep) == 0 and dp * ep > 1:
        return ("dp", "ep")
    if microbatch % dp == 0 and dp > 1:
        return ("dp",)
    return None


def batch_split(layout, microbatch: int) -> Tuple[int, int]:
    """(blocks, this rank's block) of every GPipe microbatch's rows under
    `batch_axes`: `Fsdp.rank_rows`' split for the GPipe path."""
    axes = batch_axes(layout, microbatch)
    if axes == ("dp", "ep"):
        return layout.batch_ranks, layout.batch_rank
    if axes == ("dp",):
        return layout.world, layout.rank
    return 1, 0


def gpipe_lm_loss(params: Dict[str, Any], tokens: torch.Tensor, cfg,
                  layout, num_microbatches: int
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """KTWE-LM's LM loss with the layer stack run through the explicit
    GPipe schedule: `tf.loss_fn`'s (total, {nll, aux}) contract (aux 0),
    so `trainer.make_train_step(loss_fn=...)` can drive it.

    `tokens` (B, S+1) are this rank's rows (None layout: the batch), split
    into `num_microbatches` microbatches of B/M rows; on a mesh the caller
    gives each rank its rows of every microbatch by JAX's batch axes
    (`batch_split`). The embedding runs on stage 0, the final norm and the
    LM head on every rank on the result, the CE the chunked one where
    `cfg.use_chunked_ce` (JAX's path there), else the plain CE. `layout`
    is an `Fsdp` (its stage's layers gathered over dp) or a `StageLayout`.
    With tp or sp above 1 the stage runs whole on every tp and sp rank, the
    embedding, head and CE vocab-parallel over tp (see the module note)."""
    from ..models import transformer as tf
    from ..ops.chunked_ce import chunked_softmax_xent
    from ..ops.embed import embed_tokens
    from ..ops.layers import cross_entropy_loss, rms_norm
    from ..ops.quant import as_compute

    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    b, s = inputs.shape
    m, d = num_microbatches, cfg.d_model
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches {m}")
    mp = layout is not None and layout.model_parallel
    pick = (lambda name: params[name]) if layout is None else (
        lambda name: layout.leaf(params, name))
    if _pp(layout) == 1 or layout.pp_rank == 0:
        xs = (tf._embed_vocab_parallel(pick("embed"), inputs, cfg, layout)
              if mp else embed_tokens(pick("embed"), inputs, d, cfg.dtype)
              ).reshape(m, b // m, s, d)
    else:
        xs = torch.zeros((), dtype=cfg.dtype, device=tokens.device).expand(
            m, b // m, s, d)
    stage = (params["layers"] if layout is None
             else layout.stage_params(params))
    ys = gpipe(transformer_stage_fn(cfg), stage, xs, layout)
    x = rms_norm(ys.reshape(b, s, d), pick("final_ln"))
    head = tf.output_head(params, cfg, layout)
    if mp:
        nll = tf._vocab_parallel_xent(x, head, targets, cfg, layout)
    elif cfg.use_chunked_ce:
        nll = chunked_softmax_xent(x, head, targets,
                                   min(cfg.ce_chunk, cfg.vocab_size),
                                   cfg.ce_cache_logits)
    else:
        nll = cross_entropy_loss((x @ as_compute(head, cfg.dtype)).float(),
                                 targets)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return nll, {"nll": nll, "aux": aux}
