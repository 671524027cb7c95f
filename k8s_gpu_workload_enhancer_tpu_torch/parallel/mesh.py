"""Device mesh construction and axis conventions.

Port of k8s_gpu_workload_enhancer_tpu/parallel/mesh.py. The five logical
axes, their order and the arithmetic that factors a device count over them
(`auto_mesh_config`, `strategy_to_mesh_config`) are the JAX package's; the
mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, one rank a device (train/bootstrap.py starts the
group).

- ``dp``: data parallel and FSDP (params sharded over ``dp`` on their
  ``embed`` axis, parallel/sharding.py).
- ``tp``: tensor parallelism (Megatron: heads, the MLP hidden and the
  vocab split over tp, models/transformer.py).
- ``sp``: sequence parallelism (each rank a shard of the sequence,
  attention a ring over sp: parallel/ring_attention.py).
- ``ep``: expert parallelism. The MoE experts split over ep
  (parallel/sharding.py) and the token batch over (dp, ep) jointly, dp
  major; each MoE layer carries its tokens to their experts' ranks and
  back with an all-to-all over ep (models/transformer.py `_moe_ffn`).
- ``pp``: pipeline parallelism, in the JAX package's two forms. The
  stacked (L, ...) layer leaves split over pp on their layer axis
  (parallel/sharding.py, the rule "layers" -> "pp"): by default the
  train step is the layer-stack form, where the batch is replicated over
  pp and each layer's leaves come from the stage that holds them; with
  the trainer main's --pipeline-microbatches it is the explicit GPipe
  schedule, stage-to-stage activation handoffs over pp
  (parallel/pipeline.py).

The per-axis process groups are the DeviceMesh's
(`mesh.get_group("tp")`, ...).

A serving gang's mesh is a `ServingMesh` of (dp, tp): one rank's place
on it and its communicators (parallel/comm.py) over the whole gang and
over its tp and dp groups, with rank = dp_rank * tp + tp_rank (tp
fastest, as the mesh's axis order lays it out). It gives the serving
programs (models/decode.py, models/serving.py) the Megatron collectives
that `Fsdp` gives the train step: `tp_sum`, `tp_copy`, `tp`, `tp_rank`,
and the gathers of the logits over tp and of the dense engine's slots
over dp. `from_device_mesh` builds it over a DeviceMesh's groups (gloo or
NCCL); `thread_gang` builds every rank's of a gang of threads on one
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from .comm import Comm, ProcessComm, ThreadGroup

AXES: Tuple[str, ...] = ("dp", "ep", "pp", "tp", "sp")

# Batch (tokens) is sharded over both dp and ep.
BATCH_AXES = ("dp", "ep")
SEQ_AXIS = "sp"
TENSOR_AXIS = "tp"
PIPELINE_AXIS = "pp"
EXPERT_AXIS = "ep"
FSDP_AXIS = "dp"

# Axes a mesh may not yet take above 1: (kind, ROADMAP item). None now.
_UNPORTED: Dict[str, Tuple[str, str]] = {}


@dataclass(frozen=True)
class MeshConfig:
    """Sizes for the five logical axes. Product must equal device count."""

    dp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.ep * self.tp * self.sp

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "ep": self.ep,
                "tp": self.tp, "sp": self.sp}

    def describe(self) -> str:
        live = [f"{a}={n}" for a, n in self.axis_sizes.items() if n > 1]
        return ",".join(live) or "single-device"


def auto_mesh_config(n_devices: int, want_pp: bool = True,
                     want_ep: bool = True) -> MeshConfig:
    """Factor `n_devices` across the five axes, activating as many distinct
    parallelism forms as the device count allows (powers of two first).

    8 devices  -> dp=2, tp=2, sp=2        (pp/ep code paths still run at 1)
    16 devices -> dp=2, pp=2, tp=2, sp=2
    32 devices -> all five at 2
    """
    remaining = n_devices
    sizes = {"dp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 1}
    # Priority order: tp and sp first, then dp, then pp, then ep.
    priority = ["tp", "sp", "dp"]
    if want_pp:
        priority.append("pp")
    if want_ep:
        priority.append("ep")
    i = 0
    while remaining > 1 and remaining % 2 == 0 and i < 64:
        axis = priority[i % len(priority)]
        # One doubling per axis per sweep.
        sizes[axis] *= 2
        remaining //= 2
        i += 1
    if remaining > 1:  # non-power-of-two leftover goes to dp
        sizes["dp"] *= remaining
    return MeshConfig(**sizes)


def strategy_to_mesh_config(strategy: str, n_devices: int) -> MeshConfig:
    """Map a scheduler `DistributionStrategy` to a mesh (the JAX package's
    mapping of the strategy enum)."""
    s = strategy.lower()
    if s in ("dataparallel", "fsdp"):
        return MeshConfig(dp=n_devices)
    if s == "tensorparallel":
        return MeshConfig(tp=n_devices)
    if s == "pipelineparallel":
        return MeshConfig(pp=n_devices)
    if s == "sequenceparallel":
        return MeshConfig(sp=n_devices)
    if s == "expertparallel":
        return MeshConfig(ep=n_devices)
    return auto_mesh_config(n_devices)  # Hybrid


class UnportedAxisError(ValueError):
    """A mesh asks for parallelism the port does not have yet."""


def check_supported(config: MeshConfig) -> None:
    """Raise UnportedAxisError if the mesh asks for parallelism the port
    does not have, rather than running it as something else. Every axis
    of `AXES` is ported, so no mesh is refused; callers keep the check."""
    for axis, (kind, item) in _UNPORTED.items():
        n = config.axis_sizes[axis]
        if n > 1:
            raise UnportedAxisError(
                f"mesh axis {axis}={n}: {kind} parallelism is not ported "
                f"yet (ROADMAP {item}) (mesh {config.describe()})")


def make_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda"):
    """The 5-axis DeviceMesh over the default process group's ranks, axes
    in `AXES` order. With `config=None`, auto-factor the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(train/bootstrap.initialize starts one)")
    world = dist.get_world_size()
    if config is None:
        config = auto_mesh_config(world)
    if config.num_devices != world:
        raise ValueError(
            f"mesh {config.axis_sizes} needs {config.num_devices} devices, "
            f"got {world}")
    check_supported(config)
    shape = tuple(config.axis_sizes[a] for a in AXES)
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES)


class ServingMesh:
    """One rank of a (dp, tp) serving gang (see the module note). `world`
    is the whole gang's communicator, `tp_comm` this rank's tp group's
    (the ranks of its dp row), `dp_comm` its dp group's (the ranks of its
    tp column)."""

    def __init__(self, dp: int, tp: int, world: Comm, tp_comm: Comm,
                 dp_comm: Comm):
        self.dp, self.tp = int(dp), int(tp)
        self.world, self.tp_comm, self.dp_comm = world, tp_comm, dp_comm
        self.rank = world.rank
        if world.size != self.dp * self.tp:
            raise ValueError(f"a (dp={dp}, tp={tp}) serving mesh needs "
                             f"{self.dp * self.tp} ranks, got {world.size}")

    @property
    def size(self) -> int:
        return self.dp * self.tp

    @property
    def shape(self) -> Tuple[int, int]:
        return self.dp, self.tp

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def is_driver(self) -> bool:
        return self.rank == 0

    def describe(self) -> str:
        return f"dp={self.dp},tp={self.tp}"

    # -- Megatron's f and g, and the gathers --

    def tp_copy(self, x: torch.Tensor) -> torch.Tensor:
        """`x` into a column-parallel product (inference: the identity)."""
        return x

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The tp ranks' partial results summed in rank order."""
        return self.tp_comm.all_reduce_sum(x)

    def tp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' blocks of `dim` (vocab columns) concatenated."""
        return self.tp_comm.all_gather(x.contiguous(), dim % x.dim())

    def dp_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The dp ranks' blocks of `dim` (slots) concatenated."""
        return self.dp_comm.all_gather(x.contiguous(), dim % x.dim())

    # -- construction --

    @classmethod
    def from_device_mesh(cls, device_mesh, device: torch.device
                         ) -> "ServingMesh":
        """Over a DeviceMesh of the bootstrap (`make_mesh`, axes AXES) whose
        live axes are dp and tp."""
        dp, tp = device_mesh["dp"].size(), device_mesh["tp"].size()
        if device_mesh.size() != dp * tp:
            raise ValueError(f"a serving mesh has dp and tp only, got "
                             f"{device_mesh.shape} over "
                             f"{device_mesh.mesh_dim_names}")
        d, t = divmod(dist.get_rank(), tp)
        return cls(dp, tp,
                   ProcessComm(None, range(dp * tp), device),
                   ProcessComm(device_mesh.get_group("tp"),
                               [d * tp + i for i in range(tp)], device),
                   ProcessComm(device_mesh.get_group("dp"),
                               [i * tp + t for i in range(dp)], device))

    @classmethod
    def thread_gang(cls, dp: int, tp: int) -> Tuple[List["ServingMesh"],
                                                   List[ThreadGroup]]:
        """Every rank's mesh of a gang of dp * tp threads, and the gang's
        thread groups (`ThreadGroup.abort` them when a rank fails)."""
        world = ThreadGroup(dp * tp)
        tps = [ThreadGroup(tp) for _ in range(dp)]
        dps = [ThreadGroup(dp) for _ in range(tp)]
        meshes = [cls(dp, tp, world.comm(r), tps[r // tp].comm(r % tp),
                      dps[r % tp].comm(r // tp)) for r in range(dp * tp)]
        return meshes, [world] + tps + dps
