"""Parameter sharding rules and the FSDP layout of the param tree.

Port of k8s_gpu_workload_enhancer_tpu/parallel/sharding.py. Every
parameter carries a tuple of logical axis names
(`models/transformer.param_logical_axes`); `DEFAULT_RULES` maps logical
names to mesh axes and `spec_for` gives the per-dim mesh axes, as in the
JAX package. `placements_for` turns a spec into DTensor placements on a
DeviceMesh (one per mesh dim: `Shard(d)` where the rule maps the leaf's
dim d to that mesh axis, `Replicate()` elsewhere), the counterpart of the
JAX `shard_params`. FSDP is the rule "embed" -> "dp": every weight's model
dim is split over the dp ranks, the norm scales stay replicated.

`Fsdp` carries that layout into the train step, on a mesh whose dp, pp,
ep, tp and sp axes may each exceed 1. A rank holds each leaf's block as a
plain tensor: its dp block of the `embed` dim (rank r holds block r, as
`Shard` lays it out), its pp block of the `layers` dim (dim 0 of every
stacked leaf: stage r holds layers r*L/pp .. (r+1)*L/pp - 1), its ep block
of the `expert` dim (the MoE experts, dim 1 of the stacked w_gate, w_up
and w_down) and its tp block of the `heads`, `kv_heads`, `mlp` or `vocab`
dim, so a leaf may be split on four dims, one for each axis; every leaf
is replicated over sp, the norm scales over dp and tp, every leaf but the
experts over ep, and embed, final_ln and lm_head over pp. The step gathers a
layer's leaves over dp just before the layer uses them (inside the rank's
ep and tp blocks): `all_gather_into_tensor` on the layer's slice of the
stacked (L, ...) leaf, inside an autograd function whose backward
reduce-scatters the gradient (the mean over dp) back to the rank's block.
The kernels thus see the gathered weights as plain contiguous tensors.
The token batch splits over (dp, ep) jointly, dp major (`rank_rows`, as
`P(("dp", "ep"))` lays it out), so ep ranks read rows of their own and an
MoE layer trades tokens with the ranks that hold their experts
(`ep_comm`, the all-to-all of models/transformer.py `_moe_ffn`); the
ranks of one (dp, ep) coordinate read the same rows whatever their pp
(and tp, sp) coordinate.

Pipeline parallelism, the layer-stack form (JAX's "layers" -> "pp" with
the batch replicated over pp): every pp rank runs the whole model on the
same rows, and `layer_params` takes layer i from the stage that holds it
(stage i // (L/pp), local index i % (L/pp)), which broadcasts its block
of the layer's leaves over pp just before use (`pp_comm`, one broadcast a
leaf and layer). Since every pp rank computes the same function of the
same rows, the owner's own gradient of its layers is the whole gradient:
the broadcast's backward moves nothing (a received copy carries no
autograd history), and a rank's backward computes weight gradients for
its own layers only. The explicit GPipe schedule (parallel/pipeline.py)
reads the stage's layers whole instead (`stage_params`). On a mesh with
tp or sp the schedule runs as JAX's does, replicated over them: every tp
and sp rank runs the whole stage (whole heads, whole MLP, the whole
sequence) on the same rows, so `stage_params` also gathers each stacked
leaf over tp on its tp dim (a leaf replicated over tp, the KV projections
under `kv_replicated`, as it is), and that gather's backward keeps this
rank's block of the gradient with no collective: every tp rank computes
the same whole gradient.

After the backward, `reduce_grads_` finishes the gradients in one fixed
order: the pp-replicated leaves' gradients (embed, final_ln, lm_head) are
pp rank 0's, broadcast over pp (every pp rank holds the same gradient in
the layer-stack form; in the GPipe schedule only stage 0 embeds and every
stage runs the same head), the stacked leaves' stay on their stage; the
dp-replicated leaves' gradients are averaged over dp; the
ep-replicated leaves' averaged over ep and the experts' divided by ep (the
all-to-all's backward has summed their ep ranks' tokens into them
already); every gradient averaged over sp (each sp rank's holds its
tokens' part), and where the KV heads do not divide over tp
(`kv_replicated`: the KV projections are replicated over tp and each rank
uses the heads its Q heads need) those leaves' gradients are summed over
tp. On the GPipe schedule with tp or sp (`stage_params` gathered the
stage whole) every tp and sp rank holds the whole gradient already: the
step leaves out the sp average, which would only move bytes, and the KV
projections' tp sum, which would multiply them by tp (`reduce_grads_`
reads the mark `stage_params` leaves). The forward's tensor-parallel
collectives are `tp_copy` (identity,
its backward an all-reduce over tp) before a column-parallel product and
`tp_sum` (an all-reduce over tp, its backward the identity) after a
row-parallel one, Megatron's f and g. On the CPU the collectives run over
gloo, on the card over NCCL.

`ExpertLayout` is the layout of a rank of an ep gang with no other live
axis over any `Comm` (a ThreadGroup's on one card): what the MoE FFN
reads of a layout, so the same `_moe_ffn` runs on virtual ep ranks.
`StageLayout` is the same for a pp gang: the layer-stack form's
`layer_params` and what the GPipe schedule reads, over a `Comm`, and for
the schedule also over a second `Comm` of tp ranks (the card's virtual
tp gang: the stage gathered whole over tp, the vocab-parallel embedding,
head and CE through that `Comm`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import comm
from .comm import Comm, ProcessComm, all_gather
from .mesh import (EXPERT_AXIS, FSDP_AXIS, PIPELINE_AXIS, SEQ_AXIS,
                   TENSOR_AXIS)

LogicalAxes = Tuple[Optional[str], ...]

# Logical axis name -> mesh axis (or tuple of mesh axes).
DEFAULT_RULES: Dict[Optional[str], object] = {
    "batch": ("dp", "ep"),     # token batches over dp+ep jointly
    "seq": "sp",               # sequence/context parallel
    "vocab": "tp",             # vocab-parallel embedding/logits
    "embed": "dp",             # FSDP: model dim sharded over dp
    "heads": "tp",             # attention heads tensor-parallel
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",               # MLP hidden tensor-parallel
    "expert": "ep",            # MoE experts expert-parallel
    "layers": "pp",            # stacked-layer leading axis over pipeline
    "stage": "pp",
    None: None,
}


def spec_for(logical: LogicalAxes) -> Tuple[object, ...]:
    """The mesh axis (or axes, or None) of each dim of a leaf under
    `DEFAULT_RULES`."""
    return tuple(DEFAULT_RULES.get(name) for name in logical)


def _axis_names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements_for(logical: LogicalAxes, mesh_dim_names: Tuple[str, ...]
                   ) -> tuple:
    """DTensor placements of a leaf on a mesh with `mesh_dim_names`: for
    each mesh dim, `Shard(d)` where the rules map the leaf's dim d onto it,
    else `Replicate()`. On a mesh dim of size 1 a Shard holds the whole
    dim."""
    from torch.distributed.tensor import Replicate, Shard
    spec = spec_for(logical)
    out = []
    for axis in mesh_dim_names:
        dims = [d for d, entry in enumerate(spec) if axis in _axis_names(entry)]
        if len(dims) > 1:
            raise ValueError(f"logical axes {logical} put dims {dims} on "
                             f"mesh axis {axis!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def param_placements(model_cfg, mesh_dim_names: Tuple[str, ...]
                     ) -> Dict[str, Any]:
    """`placements_for` over `param_logical_axes(model_cfg)`."""
    from ..models import transformer as tf
    return _map(lambda ax: placements_for(ax, mesh_dim_names),
                tf.param_logical_axes(model_cfg))


class _GatherShard(torch.autograd.Function):
    """Forward: all-gather the dp ranks' blocks of dim `dim`. Backward:
    reduce-scatter the gradient, the mean over the dp ranks."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, dim: int, fsdp: "Fsdp"):
        ctx.dim, ctx.fsdp = dim, fsdp
        return fsdp.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.fsdp.reduce_scatter_mean(grad, ctx.dim), None, None


class _TpCopy(torch.autograd.Function):
    """Megatron's f: the input as it is; the gradient all-reduced over tp."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = comm.all_reduce(g.contiguous().clone(), ctx.group)
        return g, None


class _TpSum(torch.autograd.Function):
    """Megatron's g: the sum over tp of the ranks' partial results; the
    gradient as it is (every tp rank computes the same function after)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        return comm.all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _Whole(torch.autograd.Function):
    """Forward: the whole leaf from the tp ranks' blocks of `dim`
    (`gather(block, dim)`). Backward: this rank's block of the gradient,
    with no collective: every tp rank computes the same whole gradient
    (the GPipe schedule's stage, see the module note)."""

    @staticmethod
    def forward(ctx, block: torch.Tensor, dim: int, gather, rank: int):
        ctx.dim, ctx.at, ctx.k = dim, rank * block.shape[dim], block.shape[dim]
        return gather(block, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.at, ctx.k), None, None, None


class _CommSum(torch.autograd.Function):
    """Megatron's g over a `Comm`: the ranks' partial results summed in
    rank order; the gradient as it is."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, comm: Comm):
        return comm.all_reduce_sum(x.contiguous())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def _tp_dim(logical: LogicalAxes) -> Optional[int]:
    """The dim of a leaf the rules put on tp, or None."""
    dims = [d for d, entry in enumerate(spec_for(logical))
            if TENSOR_AXIS in _axis_names(entry)]
    return dims[0] if dims else None


def _axis(mesh, name: str):
    """(group, size, this rank's coordinate) of a mesh axis."""
    return (mesh.get_group(name), mesh[name].size(),
            mesh.get_local_rank(name))


def _stage_layer(pp_comm: Optional[Comm], v: torch.Tensor, layer: int
                 ) -> torch.Tensor:
    """Layer `layer` of a stacked leaf split over pp on dim 0, of which
    `v` is this rank's block of L/pp layers: the owning stage (layer //
    (L/pp)) broadcasts its slice over pp (see the module note). On the
    owner the slice keeps its autograd history; elsewhere the received
    copy has none."""
    if pp_comm is None or pp_comm.size == 1:
        return v[layer]
    owner, local = divmod(layer, v.shape[0])
    if pp_comm.rank == owner:
        pp_comm.broadcast(v[local].detach(), owner)
        return v[local]
    return pp_comm.broadcast(
        torch.empty(v.shape[1:], dtype=v.dtype, device=v.device), owner)


class Fsdp:
    """The layout of one model's param tree on a DeviceMesh whose live axes
    are dp, pp, ep, tp and sp (see the module note). `dims` holds each
    leaf's dim sharded over dp, `pp_dims` over pp, `ep_dims` over ep,
    `tp_dims` over tp (None: replicated); `size` is the whole mesh's."""

    def __init__(self, model_cfg, mesh):
        from ..models import transformer as tf
        self.mesh = mesh
        self.size = mesh.size()
        self.group, self.world, self.rank = _axis(mesh, FSDP_AXIS)
        self.ep_group, self.ep, self.ep_rank = _axis(mesh, EXPERT_AXIS)
        self.tp_group, self.tp, self.tp_rank = _axis(mesh, TENSOR_AXIS)
        self.sp_group, self.sp, self.sp_rank = _axis(mesh, SEQ_AXIS)
        self.pp_group, self.pp, self.pp_rank = _axis(mesh, PIPELINE_AXIS)
        if self.ep > 1 and model_cfg.n_experts % self.ep:
            raise ValueError(
                f"n_experts {model_cfg.n_experts} cannot be split over "
                f"ep={self.ep}: each ep rank holds n_experts/ep experts")
        # The ep ranks' handle for the MoE token all-to-alls (none at ep 1).
        self.ep_comm: Optional[Comm] = ProcessComm(
            self.ep_group, torch.distributed.get_process_group_ranks(
                self.ep_group)) if self.ep > 1 else None
        # The pp ranks' handle: the layer broadcasts, the GPipe handoffs.
        self.pp_comm: Optional[Comm] = ProcessComm(
            self.pp_group, torch.distributed.get_process_group_ranks(
                self.pp_group)) if self.pp > 1 else None
        # The sp ranks' handle: the gathered attention's K/V all-gather.
        self.sp_comm: Optional[Comm] = ProcessComm(
            self.sp_group, torch.distributed.get_process_group_ranks(
                self.sp_group)) if self.sp > 1 else None
        # Set by `stage_params` on a model-parallel mesh, cleared by
        # `reduce_grads_`: this step's gradients are whole on every tp and
        # sp rank (the module note).
        self._stage_whole = False
        # KV heads the tp ranks cannot split evenly: the KV projections are
        # replicated over tp (GSPMD would pad them; the function is the
        # same).
        self.kv_replicated = (self.tp > 1
                              and model_cfg.n_kv_heads % self.tp != 0)
        names = mesh.mesh_dim_names
        placements = param_placements(model_cfg, names)
        shapes = tf.param_shapes(model_cfg)

        def sharded_dim(axis, size):
            index = names.index(axis)

            def one(path, p, shape):
                p = p[index]
                if not p.is_shard() or (
                        axis == TENSOR_AXIS and self.kv_replicated
                        and path in ("wk", "wv")):
                    return None
                if shape[p.dim] % size:
                    raise ValueError(
                        f"a leaf of shape {tuple(shape)} cannot be sharded "
                        f"over {axis}={size}: its dim {p.dim} (size "
                        f"{shape[p.dim]}) is not a multiple of {size}")
                return p.dim
            return _map_named(one, placements, shapes)
        self.dims = sharded_dim(FSDP_AXIS, self.world)
        self.ep_dims = sharded_dim(EXPERT_AXIS, self.ep)
        self.tp_dims = sharded_dim(TENSOR_AXIS, self.tp)
        self.pp_dims = sharded_dim(PIPELINE_AXIS, self.pp)

    @property
    def is_primary(self) -> bool:
        return torch.distributed.get_rank() == 0

    @property
    def model_parallel(self) -> bool:
        """tp or sp above 1: the model's tensor- and sequence-parallel
        forward (models/transformer.py) runs."""
        return self.tp > 1 or self.sp > 1

    # -- collectives --

    def all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor from every dp rank's block of `dim`."""
        return all_gather(shard, dim, self.group, self.world)

    def reduce_scatter_mean(self, full: torch.Tensor, dim: int
                            ) -> torch.Tensor:
        """This rank's block of `dim` of the mean of `full` over dp."""
        shape = list(full.shape)
        local = shape[:dim] + [shape[dim] // self.world] + shape[dim + 1:]
        blocks = full.reshape(shape[:dim] + [self.world] + local[dim:])
        blocks = blocks.movedim(dim, 0).reshape(
            [self.world * local[0]] + local[1:])
        out = full.new_empty(local)
        comm.reduce_scatter_into(out, blocks.contiguous(), self.group)
        return out.div_(self.world)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return comm.all_reduce(t, self.group, op)

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the dp, ep and sp ranks of a tensor (a new tensor,
        no grad): with equal token counts a rank, the global batch's mean
        of a per-rank mean."""
        t = self.all_reduce_(t.detach().clone())
        for group, n in ((self.ep_group, self.ep), (self.sp_group, self.sp)):
            if n > 1:
                comm.all_reduce(t, group)
        return t.div_(self.world * self.ep * self.sp)

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        """`x` into a column-parallel product (Megatron's f)."""
        return x if self.tp == 1 else _TpCopy.apply(x, self.tp_group)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The tp ranks' partial results summed (Megatron's g)."""
        return x if self.tp == 1 else _TpSum.apply(x, self.tp_group)

    def tp_max(self, t: torch.Tensor) -> torch.Tensor:
        """The tp ranks' elementwise max of `t` (no grad; in place)."""
        return comm.all_reduce(t, self.tp_group, "max")

    # -- the param tree --

    def shard(self, full: torch.Tensor, dim: Optional[int],
              tp_dim: Optional[int] = None,
              ep_dim: Optional[int] = None,
              pp_dim: Optional[int] = None) -> torch.Tensor:
        """This rank's block of `full`: its pp block of `pp_dim`, its tp
        block of `tp_dim`, its ep block of `ep_dim`, then its dp block of
        `dim` (`full` itself where it holds all of it)."""
        out = full
        for d, n, r in ((pp_dim, self.pp, self.pp_rank),
                        (tp_dim, self.tp, self.tp_rank),
                        (ep_dim, self.ep, self.ep_rank),
                        (dim, self.world, self.rank)):
            if d is not None and n > 1:
                k = out.shape[d] // n
                out = out.narrow(d, r * k, k)
        return out if out is full else out.clone()

    def shard_tree(self, tree):
        return _map(self.shard, tree, self.dims, self.tp_dims, self.ep_dims,
                    self.pp_dims)

    def full_tree(self, tree, to=None):
        """The full tensors of a sharded tree (no grad), each passed through
        `to` (e.g. a host copy) as soon as it is gathered (a collective:
        every rank calls it)."""
        to = to or (lambda t: t)

        def one(t, d, td, ed, pd):
            t = t.detach()
            if d is not None:
                t = self.all_gather(t, d)
            if ed is not None and self.ep > 1:
                t = all_gather(t, ed, self.ep_group, self.ep)
            if td is not None and self.tp > 1:
                t = all_gather(t, td, self.tp_group, self.tp)
            if pd is not None and self.pp > 1:
                t = all_gather(t, pd, self.pp_group, self.pp)
            return to(t)
        with torch.no_grad():
            return _map(one, tree, self.dims, self.tp_dims, self.ep_dims,
                        self.pp_dims)

    def gather(self, shard: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The leaf's tp block, whole over dp, for use in the forward; its
        gradient comes back reduce-scattered. A dp-replicated leaf is
        returned as it is."""
        if dim is None:
            return shard
        return _GatherShard.apply(shard, dim, self)

    def leaf(self, params: Dict[str, Any], name: str) -> torch.Tensor:
        """A top-level leaf (embed, lm_head, final_ln), gathered."""
        return self.gather(params[name], self.dims[name])

    def layer_params(self, params: Dict[str, Any], layer: int
                     ) -> Dict[str, torch.Tensor]:
        """Layer `layer`'s slice of every stacked leaf, from the stage that
        holds it, gathered over dp."""
        dims = self.dims["layers"]
        return {k: self.gather(_stage_layer(self.pp_comm, v, layer),
                               None if dims[k] is None else dims[k] - 1)
                for k, v in params["layers"].items()}

    def stage_params(self, params: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
        """This stage's (L/pp, ...) blocks of the stacked leaves, gathered
        over dp: a GPipe stage's weights (parallel/pipeline.py). With tp or
        sp above 1 also whole over tp, and the step's gradients marked
        whole (see the module note)."""
        dims = self.dims["layers"]
        out = {k: self.gather(v, dims[k])
               for k, v in params["layers"].items()}
        if not self.model_parallel:
            return out
        self._stage_whole = True
        tp_dims = self.tp_dims["layers"]

        def gather_tp(t, dim):
            return all_gather(t, dim, self.tp_group, self.tp)
        return {k: (v if tp_dims[k] is None or self.tp == 1 else
                    _Whole.apply(v, tp_dims[k], gather_tp, self.tp_rank))
                for k, v in out.items()}

    def reduce_grads_(self, grads: Dict[str, Any]) -> None:
        """Finish the gradients in place after the backward, in one fixed
        order: the pp-replicated leaves' are pp rank 0's; the
        dp-replicated leaves' averaged over dp; the ep-replicated leaves'
        averaged over ep, the experts' divided by ep; every leaf's averaged
        over sp; the tp-replicated KV projections' summed over tp. Each is
        one collective over a flat f32 buffer. After the GPipe stage ran
        whole over tp and sp (`stage_params`) the last two are left out."""
        whole, self._stage_whole = self._stage_whole, False
        if self.pp > 1:
            _broadcast_flat([g for g, pd in _zip_leaves(grads, self.pp_dims)
                             if pd is None], self.pp_comm)
        leaves = _zip_leaves(grads, self.dims, self.ep_dims)
        _reduce_flat([g for g, d, _ in leaves if d is None], self.group,
                     self.world)
        if self.ep > 1:
            _reduce_flat([g for g, _, ed in leaves if ed is None],
                         self.ep_group, self.ep)
            for g, _, ed in leaves:
                if ed is not None:
                    g.div_(self.ep)
        if whole:
            return
        if self.sp > 1:
            _reduce_flat([g for g, _, _ in leaves], self.sp_group, self.sp)
        if self.kv_replicated:
            layers = grads["layers"]
            _reduce_flat([layers["wk"], layers["wv"]], self.tp_group, 1)

    def sum_squares(self, grads: Dict[str, Any]) -> torch.Tensor:
        """The sum of squares of every element of the full gradient tree,
        f32: each leaf's blocks summed over the ranks that hold different
        blocks of it (dp where it is sharded over dp, ep where over ep, tp
        where over tp, pp where over pp), each block counted once."""
        owned = []
        for g, d, ed, td, pd in _zip_leaves(grads, self.dims, self.ep_dims,
                                            self.tp_dims, self.pp_dims):
            mine = ((d is not None or self.rank == 0)
                    and (ed is not None or self.ep_rank == 0)
                    and (td is not None or self.tp_rank == 0)
                    and (pd is not None or self.pp_rank == 0))
            sq = torch.sum(g.float() * g.float())
            owned.append(sq if mine else torch.zeros_like(sq))
        total = self.all_reduce_(torch.stack(owned).sum())
        for group, n in ((self.ep_group, self.ep), (self.tp_group, self.tp),
                         (self.pp_group, self.pp)):
            if n > 1:
                comm.all_reduce(total, group)
        return total

    @property
    def batch_ranks(self) -> int:
        """The batch's coordinates: dp * ep."""
        return self.world * self.ep

    @property
    def batch_rank(self) -> int:
        """This rank's batch coordinate, dp major over (dp, ep)."""
        return self.rank * self.ep + self.ep_rank

    def rank_rows(self, tokens: torch.Tensor, grad_accum: int = 1,
                  split: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """This rank's rows of a global token batch, as the JAX batch
        sharding over ("dp", "ep") gives them to its device: the
        contiguous block `batch_rank` of B/(dp*ep) rows of (B, S+1), or
        that block of every microbatch of (grad_accum, B/grad_accum, S+1).
        Ranks that differ only in pp, tp or sp read the same rows. `split`
        (blocks, this rank's block) overrides (dp*ep, batch_rank): the
        GPipe schedule's batch axes (parallel/pipeline.batch_split)."""
        blocks, block = split or (self.batch_ranks, self.batch_rank)
        axis = 0 if grad_accum == 1 else 1
        n = tokens.shape[axis]
        if n % blocks:
            what = ("dp*ep" if split is None else "the pipeline's batch "
                    "axes")
            raise ValueError(f"{n} rows a (micro)batch cannot be split over "
                             f"{what}={blocks}")
        k = n // blocks
        return tokens.narrow(axis, block * k, k)

    def seq_shard(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's sp shard of the positions (dim 1) of `t`."""
        if self.sp == 1:
            return t
        s = t.shape[1]
        if s % self.sp:
            raise ValueError(f"sequence {s} cannot be split over "
                             f"sp={self.sp}")
        k = s // self.sp
        return t.narrow(1, self.sp_rank * k, k)

    def global_means(self, frac_tokens: torch.Tensor,
                     frac_probs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The MoE load-balance fractions averaged over the ranks (one
        collective). frac_probs keeps its gradient to this rank's router:
        the mean's value with the local term's gradient, which the
        reduce-scatter then averages, as the global product needs."""
        n = frac_tokens.numel()
        both = self.mean(torch.cat([frac_tokens, frac_probs]))
        g_tokens, g_probs = both[:n], both[n:]
        return g_tokens, frac_probs + (g_probs - frac_probs.detach())


class ExpertLayout:
    """One rank of an expert-parallel gang with no other live axis, over
    `comm` (its ep ranks; a ThreadGroup's on one card): what the MoE FFN
    reads of a layout (models/transformer.py `_moe_ffn`, `_layer`). The
    rank holds n_experts/ep experts of each layer (`expert_block`) and its
    rows of the batch; the load-balance fractions are averaged over the
    ranks."""

    tp = sp = world = 1
    model_parallel = False

    def __init__(self, comm: Comm):
        self.ep_comm = comm
        self.ep, self.ep_rank = comm.size, comm.rank
        self.size = comm.size

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks (a new tensor, no grad)."""
        return self.ep_comm.all_reduce_sum(t.detach().clone()) / self.ep

    global_means = Fsdp.global_means

    def expert_block(self, lp: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """This rank's experts of one layer's leaves `lp` (the expert dim
        leading the MoE leaves: `layer_params`' slices)."""
        k = lp["w_gate"].shape[0] // self.ep
        return {n: (t.narrow(0, self.ep_rank * k, k)
                    if n in ("w_gate", "w_up", "w_down") else t)
                for n, t in lp.items()}


class StageLayout:
    """One rank of a pipeline (pp) gang with no other live axis but tp,
    over `comm` (its pp ranks; a ThreadGroup's on one card). The rank's
    params hold its stage's (L/pp, ...) block of every stacked leaf
    (`stage_block`) and every other leaf whole; every rank reads the same
    rows. It gives the layer-stack form's `layer_params` (the owning
    stage's broadcast, as `Fsdp`'s) and what the GPipe schedule reads
    (`stage_params`, `leaf`, `pp_comm`); a MoE layer on it takes the
    dense route, as on any mesh of more than one device.

    With `tp_comm` (this rank's tp ranks of a ThreadGroup; `model_cfg`
    names the leaves' tp dims) it is a rank of a (pp, tp) gang for the
    GPipe schedule only: its params are also its tp blocks (`tp_block`),
    the stage is gathered whole over tp (`stage_params`), and the
    vocab-parallel embedding, head and CE run their tp collectives through
    `tp_comm` (`tp_copy` the gang's one autograd node, see
    parallel/comm.py)."""

    sp = world = ep = 1
    ep_comm = None

    def __init__(self, comm: Comm, tp_comm: Optional[Comm] = None,
                 model_cfg=None):
        self.pp_comm = comm
        self.pp, self.pp_rank = comm.size, comm.rank
        self.tp_comm = tp_comm
        self.tp, self.tp_rank = ((tp_comm.size, tp_comm.rank) if tp_comm
                                 else (1, 0))
        self.size = comm.size * self.tp
        self.model_parallel = self.tp > 1
        self.kv_replicated = False
        self.tp_dims: Optional[Dict[str, Any]] = None
        if self.tp > 1:
            from ..models import transformer as tf
            self.kv_replicated = model_cfg.n_kv_heads % self.tp != 0
            self.tp_dims = _map_named(
                lambda name, ax: None if (
                    self.kv_replicated and name in ("wk", "wv"))
                else _tp_dim(ax), tf.param_logical_axes(model_cfg))

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else self.tp_comm.copy_sum_grad(x)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else _CommSum.apply(x, self.tp_comm)

    def tp_max(self, t: torch.Tensor) -> torch.Tensor:
        return self.tp_comm.all_reduce_max(t)

    def tp_block(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's tp block of every leaf of a param tree (views)."""
        if self.tp == 1:
            return tree

        def one(t, dim):
            if dim is None:
                return t
            k = t.shape[dim] // self.tp
            return t.narrow(dim, self.tp_rank * k, k)
        return _map(one, tree, {k: self.tp_dims[k] for k in tree})

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank holds the same rows: the rank's own (a new tensor)."""
        return t.detach().clone()

    def global_means(self, frac_tokens: torch.Tensor,
                     frac_probs: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return frac_tokens, frac_probs

    def leaf(self, params: Dict[str, Any], name: str) -> torch.Tensor:
        return params[name]

    def layer_params(self, params: Dict[str, Any], layer: int
                     ) -> Dict[str, torch.Tensor]:
        """Layer `layer`'s leaves, from the stage that holds it."""
        return {k: _stage_layer(self.pp_comm, v, layer)
                for k, v in params["layers"].items()}

    def stage_params(self, params: Dict[str, Any]
                     ) -> Dict[str, torch.Tensor]:
        """The stage's stacked leaves, whole over tp."""
        if self.tp == 1:
            return params["layers"]
        dims = self.tp_dims["layers"]
        return {k: (v if dims[k] is None else _Whole.apply(
                    v, dims[k], self.tp_comm.all_gather, self.tp_rank))
                for k, v in params["layers"].items()}

    def stage_block(self, layers: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This stage's block of full stacked leaves (views)."""
        k = next(iter(layers.values())).shape[0] // self.pp
        return {n: t.narrow(0, self.pp_rank * k, k)
                for n, t in layers.items()}


def _reduce_flat(grads, group, divisor: int) -> None:
    """All-reduce `grads` (summed, then divided by `divisor`) in place, as
    one flat f32 collective."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    comm.all_reduce(flat, group)
    if divisor != 1:
        flat.div_(divisor)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _broadcast_flat(grads, comm: Comm, src: int = 0) -> None:
    """Rank `src`'s `grads`, written into every rank's in place, as one
    flat f32 broadcast over `comm`."""
    if not grads:
        return
    flat = comm.broadcast(torch.cat([g.reshape(-1).float() for g in grads]),
                          src)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _map_named(fn, tree, *rest, name: str = ""):
    """`_map` whose `fn` also takes the leaf's key."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, *(r[k] for r in rest), name=k)
                for k, v in tree.items()}
    return fn(name, tree, *rest)


def _zip_leaves(tree, *rest) -> list:
    """(leaf, the other trees' leaves at its key...) for every leaf of
    `tree`, in its order (the trees may order their keys differently)."""
    if isinstance(tree, dict):
        return [t for k, v in tree.items()
                for t in _zip_leaves(v, *(r[k] for r in rest))]
    return [(tree, *rest)]
