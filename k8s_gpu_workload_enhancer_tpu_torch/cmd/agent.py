"""Node agent main on a GPU node: the port's counterpart of the JAX
package's cmd/agent.py, with JAX's flags and `nvml` in the place of
`libtpu`.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.agent \
        --node-name <node> [--shim-source auto|nvml|file:<path>] \
        [--file-table PATH] [--fake-topology 2x4] \
        [--telemetry-interval 5] [--port 50052] [--auth-token T] \
        [--optimizer-url http://<optimizer>:50051]

`--shim-source auto` (the default) probes NVML first (nvmlInit_v2
answers and the card count is at least 1; the probe's init is paired with
a shutdown), then opens the `--file-table` path as the client would, then
takes `--fake-topology`, and exits with JAX's message when none is there.
An explicit `nvml` raises with NVML's own text when the library or its
init fails: only `auto` falls through. `libtpu` is refused, naming
`nvml`. `/health` names the source chosen. `--port 0` serves no HTTP, as
the JAX main.

Deviations from the JAX main: no `--generation` (a GPU node has no TPU
generations); without `--optimizer-url` the points go nowhere (the JAX
main builds an in-process `OptimizerService`, a control-plane service the
port does not have).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading

from ..agent.agent import AgentConfig, AgentServer, NodeAgent
from ..discovery import nvml
from ..discovery.fakes import FakeGPUClient
from ..discovery.native_client import NativeGPUClient, read_file_samples


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ktwe-agent")
    p.add_argument("--node-name", type=str, required=True)
    p.add_argument("--shim-source", type=str, default="auto",
                   help="'nvml' (the card's counters), file:<path> metrics "
                        "table, or 'auto': probe NVML, then the "
                        "--file-table path, then fall back to "
                        "--fake-topology")
    p.add_argument("--file-table", type=str,
                   default="/run/ktwe/chip-metrics",
                   help="metrics-table path probed in auto mode (the "
                        "chart's chip-metrics hostPath mount)")
    p.add_argument("--fake-topology", type=str, default="",
                   help="dev mode: fabricate this many devices, e.g. 2x4")
    p.add_argument("--telemetry-interval", type=float, default=5.0)
    p.add_argument("--port", type=int, default=50052,
                   help="HTTP surface (health/telemetry/assign); 0 disables")
    p.add_argument("--auth-token", type=str, default="",
                   help="bearer token (or $KTWE_AUTH_TOKEN[_FILE])")
    p.add_argument("--optimizer-url", type=str, default="",
                   help="optimizer service base URL (DaemonSet mode: "
                        "http://<svc>:50051)")
    return p


def nvml_answers() -> bool:
    """True when NVML initialises and sees at least one card."""
    try:
        with nvml.Session() as session:
            return session.device_count() >= 1
    except nvml.NvmlError:
        return False


def table_opens(path: str) -> bool:
    """True when `path` is a file the client can read (a directory
    mounted over the path, or one it cannot open, falls through)."""
    if not path or not os.path.isfile(path):
        return False
    try:
        read_file_samples(path)
    except OSError:
        return False
    return True


def choose_source(args) -> str:
    if args.shim_source != "auto":
        return args.shim_source
    if nvml_answers():
        return "nvml"
    if table_opens(args.file_table):
        return f"file:{args.file_table}"
    if not args.fake_topology:
        raise SystemExit(
            "no NVML device reachable, no metrics table at "
            f"{args.file_table!r}, and no --fake-topology given")
    return ""


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    source = choose_source(args)
    if source:
        client = NativeGPUClient(args.node_name, source)
        try:
            client.initialize()
        except ValueError as e:
            raise SystemExit(f"ktwe-agent: {e}") from e
    elif args.fake_topology:
        client = FakeGPUClient(args.node_name, args.fake_topology)
        client.initialize()
    else:
        raise SystemExit("one of --shim-source / --fake-topology required")
    from ..utils.httpjson import resolve_auth_token
    token = resolve_auth_token(args.auth_token)
    optimizer = None
    if args.optimizer_url:
        from ..agent.optimizer_client import HTTPOptimizerClient
        optimizer = HTTPOptimizerClient(args.optimizer_url, token)
    agent = NodeAgent(client, AgentConfig(
        node_name=args.node_name,
        telemetry_interval_s=args.telemetry_interval,
        shim_source=source),
        optimizer_service=optimizer)
    agent.start()
    server = None
    if args.port:
        server = AgentServer(agent)
        server.start(args.port, auth_token=token)
    print(f"ktwe-agent up on {args.node_name}"
          + (f" (:{server.port})" if server else ""), flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        stop.wait()
    finally:
        if server is not None:
            server.stop()
        agent.stop()
        client.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
