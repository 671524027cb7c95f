"""Trainer of KTWE-LM: one device, or a mesh of dp (FSDP), pp, ep, tp and
sp.

Port of k8s_gpu_workload_enhancer_tpu/train/trainer.py. `init_state` and
`train_loop` take the mesh, as the JAX ones do; without one (None) they
train on one device. On a mesh (parallel/mesh.py: one rank a device; dp,
pp, ep, tp and sp may exceed 1) `init_state` shards the state as the JAX
package's rules shard it and keeps the layout in `TrainState.fsdp`
(parallel/sharding.Fsdp): each leaf with an `embed` axis, and its f32
Adam moments, hold 1/dp of that axis on each rank, the stacked layer
leaves 1/pp of their layer axis, the MoE experts 1/ep, the heads, MLP and
vocab axes 1/tp, the norm scales are replicated. The
step reads that layout from the state it is given. It takes this rank's
rows of the global batch (`Fsdp.rank_rows`, by the (dp, ep) batch
coordinate; `synthetic_batches` yields them; on an sp mesh the model
takes the rank's shard of the positions after the input/target shift),
gathers each layer's leaves over dp (and from its pp stage) before use
and reduce-scatters their gradients, then finishes them over pp, dp, ep,
sp and tp (`Fsdp.reduce_grads_`), once a microbatch, so the bf16
accumulator sums
the global microbatch gradients as the JAX step does. The global norm
counts every block of the mesh once; AdamW runs on the local blocks;
loss, nll and aux are the means over every token of the global batch
(averaged over the dp, ep and sp ranks). The optimizer is the
JAX package's optax chain written out in torch: clip_by_global_norm
(grad_clip), then AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay on every
leaf) scaled by a linear-warmup cosine schedule evaluated at the update's
pre-increment count, with decay_steps = max(total_steps, warmup_steps + 1).
The `grad_norm` metric is that of the unclipped gradients. The step
updates params and optimizer state in place, where the JAX step donates
its state. Its loss is `tf.loss_fn` unless the caller passes another of
the same contract, as the JAX step's `loss_fn` does (the explicit GPipe
schedule, parallel/pipeline.gpipe_lm_loss).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ..models import transformer as tf
from ..parallel.sharding import Fsdp
from ..utils.device import resolve_device
from .profiling import StepTimer

Params = Dict[str, Any]
Metrics = Dict[str, Any]


@dataclass
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 8          # global
    seq_len: int = 512
    seed: int = 0
    # Gradient accumulation: microbatches per optimizer step; batch_size
    # must divide evenly.
    grad_accum: int = 1
    # Accumulator dtype of the microbatch gradients: "bf16" (the JAX
    # package's default, half the accumulate traffic) or "f32".
    grad_accum_dtype: str = "bf16"

    def __post_init__(self):
        if self.grad_accum_dtype not in ("bf16", "f32"):
            raise ValueError(f"grad_accum_dtype must be 'bf16' or 'f32', "
                             f"got {self.grad_accum_dtype!r}")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")

    @property
    def microbatch_size(self) -> int:
        if self.batch_size % self.grad_accum:
            raise ValueError(f"batch_size {self.batch_size} not divisible by "
                             f"grad_accum {self.grad_accum}")
        return self.batch_size // self.grad_accum


@dataclass
class TrainState:
    params: Params
    opt_state: Dict[str, Any]     # {"count": int, "mu": tree, "nu": tree}
    step: int
    # The FSDP layout of params, mu and nu (None: whole tensors on one
    # device); checkpoints read it to gather and to shard.
    fsdp: Optional[Fsdp] = None


def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of nested dicts (several trees of one shape)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _map_with_name(fn: Callable, tree, name: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_name(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def global_norm(tree, fsdp: Optional[Fsdp] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32; under `fsdp` of
    the full tree (each block's squares once, summed over the mesh)."""
    if fsdp is not None:
        return torch.sqrt(fsdp.sum_squares(tree))
    return torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in tree_leaves(tree)))


def learning_rate(cfg: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total, warmup
    + 1)) at `count`: linear from 0 to lr over the warmup, then cosine to
    0 over the remaining steps."""
    warmup = cfg.warmup_steps
    if count < warmup:
        return cfg.learning_rate * count / warmup
    decay = max(cfg.total_steps, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * c / decay))


class AdamW:
    """clip_by_global_norm then AdamW, as `make_optimizer` chains them in
    the JAX package (optax.clip_by_global_norm, optax.adamw)."""

    b1, b2, eps = 0.9, 0.95, 1e-8

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return {"count": 0, "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def update(self, params: Params, grads: Params,
               opt_state: Dict[str, Any],
               g_norm: Optional[torch.Tensor] = None) -> None:
        """Apply one update to params and opt_state in place; `g_norm` is
        the gradients' global norm (computed here when None)."""
        cfg = self.cfg
        if g_norm is None:
            g_norm = global_norm(grads)
        clip = g_norm >= cfg.grad_clip
        count = opt_state["count"]
        lr = learning_rate(cfg, count)
        bc1 = 1.0 - self.b1 ** (count + 1)
        bc2 = 1.0 - self.b2 ** (count + 1)

        def one(p, g, mu, nu):
            g = g.to(p.dtype)
            g = torch.where(clip, g / g_norm * cfg.grad_clip, g)
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + cfg.weight_decay * p
            p.add_(u.to(p.dtype), alpha=-lr)
        tree_map(one, params, grads, opt_state["mu"], opt_state["nu"])
        opt_state["count"] = count + 1


def make_optimizer(cfg: TrainConfig) -> AdamW:
    return AdamW(cfg)


def init_state(model_cfg: tf.TransformerConfig, train_cfg: TrainConfig,
               generator: torch.Generator, mesh=None) -> TrainState:
    """f32 master params from `generator` (a torch.Generator on the device
    to train on), zero optimizer moments, step 0. On `mesh` every rank
    draws the same full params from the same seed and keeps its blocks."""
    params = tf.init_params(generator, model_cfg)
    fsdp = None
    if mesh is not None:
        fsdp = Fsdp(model_cfg, mesh)
        params = fsdp.shard_tree(params)
    params = tree_map(lambda p: p.requires_grad_(True), params)
    return TrainState(params=params,
                      opt_state=make_optimizer(train_cfg).init(params),
                      step=0, fsdp=fsdp)


def _grad(loss: torch.Tensor, tree) -> Params:
    """d loss / d every leaf of `tree`; zeros for a leaf the loss does not
    use on this rank (a GPipe stage past the first never embeds)."""
    leaves = tree_leaves(tree)
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))
    return tree_map(lambda p: _or_zeros(next(grads), p), tree)


def _or_zeros(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p) if g is None else g


def _model_loss(params: Params, tokens: torch.Tensor,
                model_cfg: tf.TransformerConfig, fsdp: Optional[Fsdp]):
    return tf.loss_fn(params, tokens, model_cfg, fsdp=fsdp)


def make_train_step(model_cfg: tf.TransformerConfig, train_cfg: TrainConfig,
                    loss_fn: Optional[Callable] = None
                    ) -> Callable[[TrainState, torch.Tensor],
                                  Tuple[TrainState, Metrics]]:
    """Returns (state, tokens) -> (state, metrics), updating state in place.

    tokens is (B, S+1) when grad_accum == 1, else (grad_accum, B/acc, S+1);
    for a state sharded over a mesh (`state.fsdp`) it is this rank's rows of
    that (`Fsdp.rank_rows`). The
    microbatches run one after another and the optimizer updates once per
    global batch. `loss_fn` overrides the model loss, as the JAX step's
    does: `(params, tokens, model_cfg, fsdp) -> (total, {nll, aux})`, the
    contract of `tf.loss_fn` with the layout (None off a mesh) in the
    JAX mesh's place (e.g. `parallel.pipeline.gpipe_lm_loss` to train
    through the explicit GPipe schedule); None = `tf.loss_fn`."""
    model_loss = loss_fn if loss_fn is not None else _model_loss
    optimizer = make_optimizer(train_cfg)
    acc = train_cfg.grad_accum
    acc_dt = torch.bfloat16 if train_cfg.grad_accum_dtype == "bf16" \
        else torch.float32

    def to_compute(name: str, p: torch.Tensor) -> torch.Tensor:
        # Differentiate w.r.t. compute-dtype weights, cast once per step:
        # the model casts every matmul weight to cfg.dtype at use anyway.
        # Norm scales (name-matched) and 1-d leaves stay master dtype, as
        # rms_norm consumes them at f32.
        if "ln" in name or p.dim() < 2:
            return p
        return p.detach().to(model_cfg.dtype).requires_grad_(True)

    def loss_and_grads(params: Params, toks: torch.Tensor,
                       fsdp: Optional[Fsdp]):
        total, parts = model_loss(params, toks, model_cfg, fsdp)
        grads = _grad(total, params)
        if fsdp is not None:
            fsdp.reduce_grads_(grads)
        return total, parts, grads

    def step_fn(state: TrainState, tokens: torch.Tensor
                ) -> Tuple[TrainState, Metrics]:
        fsdp = state.fsdp
        if acc == 1:
            total, parts, grads = loss_and_grads(state.params, tokens, fsdp)
            total, nll, aux = (total.detach(), parts["nll"].detach(),
                               parts["aux"].detach())
        else:
            compute = _map_with_name(to_compute, state.params)
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dt),
                             state.params)
            total = nll = aux = 0.0
            for micro in range(acc):
                tot, parts, g = loss_and_grads(compute, tokens[micro], fsdp)
                with torch.no_grad():
                    grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                total = total + tot.detach()
                nll = nll + parts["nll"].detach()
                aux = aux + parts["aux"].detach()
            grads = tree_map(lambda g, p: (g.float() / acc).to(p.dtype),
                             grads, state.params)
            total, nll, aux = total / acc, nll / acc, aux / acc
        gnorm = global_norm(grads, fsdp)
        optimizer.update(state.params, grads, state.opt_state, gnorm)
        if fsdp is not None:
            total, nll, aux = fsdp.mean(torch.stack([total, nll, aux]))
        state.step += 1
        return state, {"loss": total, "nll": nll, "aux": aux,
                       "grad_norm": gnorm, "step": state.step}

    return step_fn


def synthetic_batches(model_cfg: tf.TransformerConfig,
                      train_cfg: TrainConfig, device="cuda",
                      fsdp: Optional[Fsdp] = None,
                      split: Optional[Tuple[int, int]] = None
                      ) -> Iterator[torch.Tensor]:
    """Deterministic synthetic LM data, made on the device from seed + 1.
    Every rank draws the global batch; under `fsdp` (a state's layout) it
    yields this rank's rows of it (`Fsdp.rank_rows`, `split` its
    override)."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(train_cfg.seed + 1)
    acc = train_cfg.grad_accum
    shape = ((train_cfg.batch_size, train_cfg.seq_len + 1) if acc == 1 else
             (acc, train_cfg.microbatch_size, train_cfg.seq_len + 1))
    while True:
        toks = torch.randint(0, model_cfg.vocab_size, shape, generator=gen,
                             device=device)
        yield toks if fsdp is None else fsdp.rank_rows(toks, acc, split)


def train_loop(model_cfg: tf.TransformerConfig, train_cfg: TrainConfig,
               num_steps: int = 10, callback=None, device="cuda",
               stop: Optional[Callable[[], bool]] = None,
               timer: Optional[StepTimer] = None,
               state: Optional[TrainState] = None,
               batches: Optional[Iterator[torch.Tensor]] = None,
               mesh=None, loss_fn: Optional[Callable] = None
               ) -> Dict[str, Any]:
    """Train from `state` (default: a fresh state seeded from
    train_cfg.seed, sharded over `mesh` when one is given) until it
    reaches step `num_steps`, on `batches` (default: synthetic batches, this
    rank's rows under `state.fsdp`). The step updates `state` in place;
    `loss_fn` is `make_train_step`'s.
    Each step is timed by `timer` (a StepTimer, made here when None) and ends in
    a host read of the loss, so its wall time covers the device's work.
    `callback(i, metrics)` runs after step i (counted from 0 at a fresh
    state); the loop ends early once `stop()` is true after a step.
    Returns the timer's summary (the first step, which builds the kernels,
    left out) with `final_loss` and `steps_run`."""
    device = resolve_device(device)
    if state is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(train_cfg.seed)
        state = init_state(model_cfg, train_cfg, gen, mesh)
    step = make_train_step(model_cfg, train_cfg, loss_fn)
    if batches is None:
        batches = synthetic_batches(model_cfg, train_cfg, device, state.fsdp)
    timer = timer if timer is not None else StepTimer()
    tokens = train_cfg.batch_size * train_cfg.seq_len
    flops = tokens * model_cfg.flops_per_token(train_cfg.seq_len)
    loss, steps_run = float("nan"), 0
    for i in range(state.step, num_steps):
        with timer.step(i, tokens=tokens, flops=flops):
            state, metrics = step(state, next(batches))
            loss = float(metrics["loss"])    # waits for the device
        steps_run += 1
        if callback is not None:
            callback(i, metrics)
        if stop is not None and stop():
            break
    return {"final_loss": loss, "steps_run": steps_run, **timer.summary()}
