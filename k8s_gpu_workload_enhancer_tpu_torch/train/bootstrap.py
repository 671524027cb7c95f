"""Gang bootstrap: read the env the controller injects and bring up
`torch.distributed` and the mesh.

Port of k8s_gpu_workload_enhancer_tpu/train/bootstrap.py. The launcher
(the JAX package's controller/launcher.py) sets COORDINATOR_ADDRESS,
NUM_PROCESSES, PROCESS_ID, KTWE_MESH_AXES and KTWE_STRATEGY in every pod of
a gang; the trainer main calls `initialize` first:

    ctx = bootstrap.initialize(device="cuda")
    state = trainer.init_state(model_cfg, train_cfg, gen, ctx.mesh)

A gang (NUM_PROCESSES > 1) joins one process group: rendezvous at `tcp://COORDINATOR_ADDRESS`, rank
PROCESS_ID, world size NUM_PROCESSES, backend "nccl" on the card and
"gloo" when the caller asks for the CPU, with a finite timeout
(`COLLECTIVE_TIMEOUT_S`) so that a lost peer fails a collective instead of
hanging it. One process is one rank on one device,
`cuda:{LOCAL_RANK or 0}` (the JAX package runs one process a host over
all of its chips). The mesh is then a DeviceMesh of NUM_PROCESSES devices
(parallel/mesh.py) whose dp, pp, ep, tp and sp axes may exceed 1, from
KTWE_MESH_AXES ("dp=2,pp=2", "dp=2,ep=2,tp=2") or KTWE_STRATEGY (FSDP,
PipelineParallel, TensorParallel, SequenceParallel, ExpertParallel,
Hybrid, ...), as the JAX bootstrap reads them (`mesh_config`). At
NUM_PROCESSES 1 the
context is the single-process one, COORDINATOR_ADDRESS or not (as the JAX
bootstrap starts no distributed runtime for one process): no process
group, no mesh, one device, and the trainer's single-device step.
`group_of_one=True` joins a group and builds the mesh even then, so that
the FSDP step and its collectives can be checked on a single card.

A serving gang (`initialize_serving`) comes up from the same env with the
(dp, tp) mesh of the serve main's --mesh, and serves through a
`parallel/mesh.ServingMesh` over the DeviceMesh's groups.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel import comm
from ..parallel import mesh as mesh_lib
from ..utils.device import resolve_device

# Longest wait of one collective (the first includes every rank's start);
# the serving gang's thread groups wait as long.
COLLECTIVE_TIMEOUT_S = comm.COLLECTIVE_TIMEOUT_S


@dataclass
class BootstrapContext:
    process_id: int
    num_processes: int
    coordinator: str
    mesh: Any                   # a DeviceMesh, or None off a gang
    mesh_config: mesh_lib.MeshConfig
    strategy: str
    device: torch.device

    @property
    def is_primary(self) -> bool:
        return self.process_id == 0

    def close(self) -> None:
        """Leave the process group this context joined (if any)."""
        if self.mesh is not None and dist.is_initialized():
            dist.destroy_process_group()
            self.mesh = None


def parse_mesh_axes(value: str) -> Dict[str, int]:
    """"dp=2,tp=2,sp=2" -> {"dp": 2, "tp": 2, "sp": 2}."""
    out: Dict[str, int] = {}
    for part in value.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = int(v)
    return out


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def mesh_config(env: Optional[Dict[str, str]] = None,
                group_of_one: bool = False) -> mesh_lib.MeshConfig:
    """The mesh the gang env asks for (KTWE_MESH_AXES, else KTWE_STRATEGY
    over NUM_PROCESSES devices; one device off a gang), checked against
    the device count but not yet against what the port supports."""
    env = dict(os.environ if env is None else env)
    num_processes = int(env.get("NUM_PROCESSES", "1"))
    strategy = env.get("KTWE_STRATEGY", "FSDP")
    axes_env = env.get("KTWE_MESH_AXES", "")
    n_dev = num_processes if (num_processes > 1 or group_of_one) else 1
    if axes_env:
        sizes = parse_mesh_axes(axes_env)
        cfg = mesh_lib.MeshConfig(**{a: sizes.get(a, 1)
                                     for a in ("dp", "pp", "ep", "tp", "sp")})
        if cfg.num_devices != n_dev:
            raise ValueError(
                f"KTWE_MESH_AXES={axes_env!r} needs {cfg.num_devices} "
                f"devices; runtime has {n_dev}")
    else:
        cfg = mesh_lib.strategy_to_mesh_config(strategy, n_dev)
    return cfg


def initialize(env: Optional[Dict[str, str]] = None, device="cuda",
               group_of_one: bool = False,
               config: Optional[mesh_lib.MeshConfig] = None
               ) -> BootstrapContext:
    """The gang's context from `env` (default: os.environ) on `device`
    ("cuda", raising without a card, or "cpu"); see the module note.
    `config` is the mesh when the caller has its own (the serve main's
    --mesh) in place of KTWE_MESH_AXES / KTWE_STRATEGY."""
    env = dict(os.environ if env is None else env)
    coordinator = env.get("COORDINATOR_ADDRESS", "")
    num_processes = int(env.get("NUM_PROCESSES", "1"))
    process_id = int(env.get("PROCESS_ID", "0"))
    strategy = env.get("KTWE_STRATEGY", "FSDP")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
    gang = num_processes > 1 or group_of_one
    cfg = config if config is not None else mesh_config(env, group_of_one)
    if config is not None and config.num_devices != (
            num_processes if gang else 1):
        raise ValueError(f"mesh {config.describe()} needs "
                         f"{config.num_devices} devices; the gang has "
                         f"{num_processes} processes")
    mesh_lib.check_supported(cfg)
    mesh = None
    if gang:
        if not coordinator:
            raise ValueError(f"NUM_PROCESSES={num_processes} needs a "
                             f"COORDINATOR_ADDRESS")
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=_init_method(coordinator), world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            **kw)
        mesh = mesh_lib.make_mesh(cfg, dev.type)
    return BootstrapContext(
        process_id=process_id, num_processes=num_processes,
        coordinator=coordinator, mesh=mesh, mesh_config=cfg,
        strategy=strategy, device=dev)


def initialize_serving(mesh_shape: Optional[Tuple[int, int]],
                       env: Optional[Dict[str, str]] = None, device="cuda",
                       group_of_one: bool = False):
    """A serving gang from the launcher env (COORDINATOR_ADDRESS,
    NUM_PROCESSES, PROCESS_ID) with the mesh (dp, tp) the serve main's
    --mesh gives (None: one device), not KTWE_MESH_AXES. Returns (the
    context, this rank's ServingMesh), the mesh None off a gang."""
    dp, tp = mesh_shape or (1, 1)
    ctx = initialize(env, device, group_of_one,
                     config=mesh_lib.MeshConfig(dp=dp, tp=tp))
    if ctx.mesh is None:
        return ctx, None
    return ctx, mesh_lib.ServingMesh.from_device_mesh(ctx.mesh, ctx.device)
