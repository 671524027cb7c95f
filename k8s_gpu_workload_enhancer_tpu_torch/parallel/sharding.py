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

`Fsdp` carries that layout into the train step. A rank holds each
sharded leaf's contiguous block of the dp axis (rank r holds block r, as
`Shard` lays it out) as a plain tensor, and the step gathers a layer's
leaves just before the layer uses them: `all_gather_into_tensor` on the
layer's slice of the stacked (L, ...) leaf, inside an autograd function
whose backward reduce-scatters the gradient (the mean over the ranks) back
to the rank's block. The kernels thus see the gathered weights as plain
contiguous tensors. Replicated leaves' gradients are all-reduced
(`reduce_replicated_`). On the CPU the collectives run over gloo, on the
card over NCCL.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import FSDP_AXIS

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


def _all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, op=dist.ReduceOp.SUM, group=group)


class _GatherShard(torch.autograd.Function):
    """Forward: all-gather the ranks' blocks of dim `dim`. Backward:
    reduce-scatter the gradient, the mean over the ranks."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, dim: int, fsdp: "Fsdp"):
        ctx.dim, ctx.fsdp = dim, fsdp
        return fsdp.all_gather(shard, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.fsdp.reduce_scatter_mean(grad, ctx.dim), None, None


class Fsdp:
    """The FSDP layout of one model's param tree on a DeviceMesh whose only
    axis above size 1 is dp (see the module note). `dims` holds each leaf's
    sharded dim (None: replicated)."""

    def __init__(self, model_cfg, mesh):
        from ..models import transformer as tf
        self.mesh = mesh
        self.group = mesh.get_group(FSDP_AXIS)
        self.world = mesh[FSDP_AXIS].size()
        self.rank = mesh.get_local_rank(FSDP_AXIS)
        dp = mesh.mesh_dim_names.index(FSDP_AXIS)

        def sharded_dim(placements, shape):
            p = placements[dp]
            if not p.is_shard():
                return None
            if shape[p.dim] % self.world:
                raise ValueError(
                    f"a leaf of shape {tuple(shape)} cannot be sharded over "
                    f"dp={self.world}: its dim {p.dim} (size "
                    f"{shape[p.dim]}) is not a multiple of {self.world}")
            return p.dim
        self.dims = _map(sharded_dim,
                         param_placements(model_cfg, mesh.mesh_dim_names),
                         tf.param_shapes(model_cfg))

    @property
    def is_primary(self) -> bool:
        return dist.get_rank() == 0

    # -- collectives --

    def all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor from every rank's block of `dim` (contiguous)."""
        shard = shard.contiguous()
        shape = list(shard.shape)
        # The ranks' blocks concatenated on dim 0 (the form every backend
        # takes), then moved into place.
        out = shard.new_empty([self.world * shape[0]] + shape[1:])
        _all_gather_into(out, shard, self.group)
        full = list(shape)
        full[dim] *= self.world
        if dim == 0:
            return out
        return out.view([self.world] + shape).movedim(0, dim).reshape(full)

    def reduce_scatter_mean(self, full: torch.Tensor, dim: int
                            ) -> torch.Tensor:
        """This rank's block of `dim` of the mean of `full` over ranks."""
        shape = list(full.shape)
        local = shape[:dim] + [shape[dim] // self.world] + shape[dim + 1:]
        blocks = full.reshape(shape[:dim] + [self.world] + local[dim:])
        blocks = blocks.movedim(dim, 0).reshape(
            [self.world * local[0]] + local[1:])
        out = full.new_empty(local)
        _reduce_scatter_into(out, blocks.contiguous(), self.group)
        return out.div_(self.world)

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks of a tensor (a new tensor, no grad)."""
        return self.all_reduce_(t.detach().clone()).div_(self.world)

    # -- the param tree --

    def shard(self, full: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """This rank's block of `full` (`full` itself when replicated or
        when the rank holds all of it)."""
        if dim is None or self.world == 1:
            return full
        k = full.shape[dim] // self.world
        return full.narrow(dim, self.rank * k, k).clone()

    def shard_tree(self, tree):
        return _map(lambda t, d: self.shard(t, d), tree, self.dims)

    def full_tree(self, tree, to=None):
        """The full tensors of a sharded tree (no grad), each passed through
        `to` (e.g. a host copy) as soon as it is gathered."""
        to = to or (lambda t: t)

        def one(t, d):
            t = t.detach()
            return to(t if d is None else self.all_gather(t, d))
        with torch.no_grad():
            return _map(one, tree, self.dims)

    def gather(self, shard: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The full leaf for use in the forward; its gradient comes back
        reduce-scattered. A replicated leaf is returned as it is."""
        if dim is None:
            return shard
        return _GatherShard.apply(shard, dim, self)

    def leaf(self, params: Dict[str, Any], name: str) -> torch.Tensor:
        """A top-level leaf (embed, lm_head, final_ln), gathered."""
        return self.gather(params[name], self.dims[name])

    def layer_params(self, params: Dict[str, Any], layer: int
                     ) -> Dict[str, torch.Tensor]:
        """Layer `layer`'s slice of every stacked leaf, gathered."""
        dims = self.dims["layers"]
        return {k: self.gather(v[layer], None if dims[k] is None
                               else dims[k] - 1)
                for k, v in params["layers"].items()}

    def reduce_replicated_(self, grads: Dict[str, Any]) -> None:
        """All-reduce (mean) the gradients of the replicated leaves in
        place, in one collective."""
        reps = [g for g, d in zip(_leaves(grads), _leaves(self.dims))
                if d is None]
        if not reps:
            return
        flat = torch.cat([g.reshape(-1).float() for g in reps])
        self.all_reduce_(flat).div_(self.world)
        for g, part in zip(reps, flat.split([g.numel() for g in reps])):
            g.copy_(part.view_as(g))

    def sum_squares(self, grads: Dict[str, Any]) -> torch.Tensor:
        """The sum of squares of every element of the full gradient tree,
        f32: the sharded leaves' blocks summed over the ranks, the
        replicated leaves once."""
        sharded, replicated = [], []
        for g, d in zip(_leaves(grads), _leaves(self.dims)):
            (replicated if d is None else sharded).append(
                torch.sum(g.float() * g.float()))
        total = self.all_reduce_(torch.stack(sharded).sum())
        return total + torch.stack(replicated).sum() if replicated else total

    def rank_rows(self, tokens: torch.Tensor, grad_accum: int = 1
                  ) -> torch.Tensor:
        """This rank's rows of a global token batch, as the JAX batch
        sharding over ("dp", "ep") gives them to its device: the
        contiguous block of B/dp rows of (B, S+1), or that block of every
        microbatch of (grad_accum, B/grad_accum, S+1)."""
        axis = 0 if grad_accum == 1 else 1
        n = tokens.shape[axis]
        if n % self.world:
            raise ValueError(f"{n} rows a (micro)batch cannot be split over "
                             f"dp={self.world}")
        k = n // self.world
        return tokens.narrow(axis, self.rank * k, k)

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


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]
