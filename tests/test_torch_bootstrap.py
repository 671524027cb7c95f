"""The port's gang bootstrap, mesh arithmetic and sharding rules against the
JAX package's (train/bootstrap.py, parallel/mesh.py, parallel/sharding.py).

`parse_mesh_axes`, `auto_mesh_config` for 1..32 devices (with and without
pp and ep) and `strategy_to_mesh_config` for every strategy give the JAX
answers; the size-mismatch error is the JAX message; a live pp, ep, tp or
sp axis passes (the mesh check, the strategy that asks for pp, the
trainer main's `refused`), the MoE model on it too; the single-process
context, also at
NUM_PROCESSES 1 with a coordinator, has no process group, and
`group_of_one` joins a gloo group of one (the only group a test here
starts, closed before it ends); `param_logical_axes`, `DEFAULT_RULES` and
`spec_for` equal the JAX ones, and the FSDP placements shard exactly the
`embed` axis.
"""

import socket

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from k8s_gpu_workload_enhancer_tpu.models import transformer as jtf
from k8s_gpu_workload_enhancer_tpu.parallel import mesh as jmesh
from k8s_gpu_workload_enhancer_tpu.parallel import sharding as jsharding
from k8s_gpu_workload_enhancer_tpu.train import bootstrap as jboot
from k8s_gpu_workload_enhancer_tpu_torch.cmd import trainer as cli
from k8s_gpu_workload_enhancer_tpu_torch.models import transformer as ttf
from k8s_gpu_workload_enhancer_tpu_torch.parallel import mesh as tmesh
from k8s_gpu_workload_enhancer_tpu_torch.parallel import sharding as tsharding
from k8s_gpu_workload_enhancer_tpu_torch.train import bootstrap as tboot

import torch_parity  # noqa: F401  (one intra-op thread a process)

STRATEGIES = ("DataParallel", "FSDP", "TensorParallel", "PipelineParallel",
              "SequenceParallel", "ExpertParallel", "Hybrid")


def _sizes(cfg):
    return cfg.axis_sizes


@pytest.mark.parametrize("value", ["dp=2, tp=4", "", "dp=8", " dp = 2 ,,ep=2",
                                   "dp=2,pp=2,ep=2,tp=2,sp=2"])
def test_parse_mesh_axes_matches_jax(value):
    assert tboot.parse_mesh_axes(value) == jboot.parse_mesh_axes(value)


def test_axes_and_constants_match_jax():
    assert tmesh.AXES == jmesh.AXES
    assert (tmesh.BATCH_AXES, tmesh.SEQ_AXIS, tmesh.TENSOR_AXIS,
            tmesh.PIPELINE_AXIS, tmesh.EXPERT_AXIS, tmesh.FSDP_AXIS) == (
        jmesh.BATCH_AXES, jmesh.SEQ_AXIS, jmesh.TENSOR_AXIS,
        jmesh.PIPELINE_AXIS, jmesh.EXPERT_AXIS, jmesh.FSDP_AXIS)


@pytest.mark.parametrize("want_pp,want_ep", [(True, True), (False, True),
                                             (True, False), (False, False)])
def test_auto_mesh_config_matches_jax(want_pp, want_ep):
    for n in range(1, 33):
        got = tmesh.auto_mesh_config(n, want_pp, want_ep)
        want = jmesh.auto_mesh_config(n, want_pp, want_ep)
        assert _sizes(got) == _sizes(want), n
        assert got.num_devices == want.num_devices == n
        assert got.describe() == want.describe()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_to_mesh_config_matches_jax(strategy):
    for n in range(1, 33):
        assert _sizes(tmesh.strategy_to_mesh_config(strategy, n)) == _sizes(
            jmesh.strategy_to_mesh_config(strategy, n)), (strategy, n)


def test_single_process_context():
    ctx = tboot.initialize({"KTWE_STRATEGY": "FSDP"}, device="cpu")
    assert ctx.is_primary
    assert ctx.num_processes == 1
    assert ctx.mesh is None and ctx.mesh_config.dp == 1
    assert ctx.device == torch.device("cpu")
    assert ctx.strategy == "FSDP"
    assert not dist.is_initialized()
    ctx.close()


def test_one_process_joins_no_group_unless_asked():
    """NUM_PROCESSES 1 with a COORDINATOR_ADDRESS (what the launcher gives
    a gang of one) is the single-process context, as JAX starts no
    distributed runtime for one process; `group_of_one` joins a group of
    one and builds the mesh all the same."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"COORDINATOR_ADDRESS": f"localhost:{port}", "NUM_PROCESSES": "1",
           "PROCESS_ID": "0", "KTWE_STRATEGY": "FSDP"}
    ctx = tboot.initialize(env, device="cpu")
    assert ctx.mesh is None and not dist.is_initialized()
    ctx = tboot.initialize(env, device="cpu", group_of_one=True)
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert ctx.mesh.mesh_dim_names == tmesh.AXES
        assert ctx.mesh.size() == 1 and ctx.mesh_config.dp == 1
    finally:
        ctx.close()
    assert not dist.is_initialized()


def test_mesh_axes_size_mismatch_raises_the_jax_message():
    env = {"KTWE_MESH_AXES": "dp=64"}
    with pytest.raises(ValueError) as want:
        jboot.initialize(env)
    with pytest.raises(ValueError) as got:
        tboot.initialize(env, device="cpu")
    # The same text but the device count each runtime has (JAX: the 8 CPU
    # devices of the test harness; the port: one device a process).
    assert str(got.value) == str(want.value).replace("has 8", "has 1")
    with pytest.raises(ValueError, match="needs 4 devices; runtime has 2"):
        tboot.initialize({"KTWE_MESH_AXES": "dp=4", "NUM_PROCESSES": "2",
                          "COORDINATOR_ADDRESS": "localhost:1"},
                         device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("axis", ["ep", "pp", "tp", "sp"])
def test_a_live_model_parallel_axis_is_refused_naming_a11(axis, capsys):
    """Every axis is ported: the mesh passes, and the trainer main refuses
    nothing on it, MoE included (the gangs that train it:
    tests/test_torch_expert_parallel.py, tests/test_torch_gpipe.py); the
    strategy that asks for pp gives JAX's pp mesh, which passes too."""
    env = {"KTWE_MESH_AXES": f"dp=1,{axis}=2", "NUM_PROCESSES": "2",
           "PROCESS_ID": "0", "COORDINATOR_ADDRESS": "localhost:1"}
    tmesh.check_supported(tmesh.MeshConfig(**{axis: 2}))
    args = cli.build_parser().parse_args(["--device", "cpu", "--steps",
                                          "1", "--n-experts", "4"])
    assert cli.refused(args, tboot.mesh_config(env)) is None
    if axis == "pp":
        strategy = {"KTWE_STRATEGY": "PipelineParallel",
                    "NUM_PROCESSES": "2",
                    "COORDINATOR_ADDRESS": "localhost:1"}
        cfg = tboot.mesh_config(strategy)
        assert cfg == tmesh.MeshConfig(pp=2)
        tmesh.check_supported(cfg)
        assert cli.refused(args, cfg) is None
        assert "A11d" not in capsys.readouterr().err
    assert not dist.is_initialized()


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(tmesh.MeshConfig(), "cpu")


def test_a_gang_needs_a_coordinator():
    with pytest.raises(ValueError, match="COORDINATOR_ADDRESS"):
        tboot.initialize({"NUM_PROCESSES": "2"}, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tboot.initialize({})


@pytest.mark.parametrize("experts", [0, 4])
def test_param_logical_axes_and_specs_match_jax(experts):
    dims = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=2,
                n_kv_heads=2, d_ff=128, max_seq=16, n_experts=experts)
    got = ttf.param_logical_axes(ttf.TransformerConfig(**dims))
    want = jtf.param_logical_axes(jtf.TransformerConfig(**dims))
    assert got == want
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            return [x for k, v in tree.items()
                    for x in leaves(v, f"{prefix}/{k}")]
        return [(prefix, tree)]
    for name, logical in leaves(got):
        assert P(*tsharding.spec_for(logical)) == jsharding.spec_for(
            logical), name
        placements = tsharding.placements_for(logical, tmesh.AXES)
        dp = placements[tmesh.AXES.index("dp")]
        if "embed" in logical:
            assert dp.is_shard(logical.index("embed")), name
        else:
            assert dp.is_replicate(), name
    assert set(ttf.param_shapes(ttf.TransformerConfig(**dims))) == set(got)


def test_fsdp_layout_refuses_a_model_dim_the_ranks_do_not_divide():
    class Mesh:            # a dp=4 mesh, as far as the layout asks
        mesh_dim_names = tmesh.AXES

        def __init__(self, n=4):
            self.n = n

        def get_group(self, axis):
            return None

        def __getitem__(self, axis):
            return Mesh(4 if axis == "dp" else 1)

        def size(self):
            return self.n

        def get_local_rank(self, axis):
            return 0

    cfg = ttf.TransformerConfig(vocab_size=32, d_model=6, n_layers=1,
                                n_heads=2, n_kv_heads=2, d_ff=8, max_seq=8)
    with pytest.raises(ValueError, match="not a multiple of 4"):
        tsharding.Fsdp(cfg, Mesh())
    layout = tsharding.Fsdp(ttf.TransformerConfig(
        vocab_size=32, d_model=8, n_layers=1, n_heads=2, n_kv_heads=2,
        d_ff=8, max_seq=8), Mesh())
    toks = torch.arange(8 * 5).reshape(8, 5)
    assert torch.equal(layout.rank_rows(toks), toks[:2])
    micro = toks.reshape(2, 4, 5)
    assert torch.equal(layout.rank_rows(micro, 2), micro[:, :1])
    with pytest.raises(ValueError, match="cannot be split"):
        layout.rank_rows(toks[:6])
