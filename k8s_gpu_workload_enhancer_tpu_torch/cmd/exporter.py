"""Standalone exporter main on a GPU node: the node's chip families
(monitoring/exporter.py) over its device layer, the port's counterpart of
the JAX package's cmd/exporter.py in its `--shim-source` mode.

    python -m k8s_gpu_workload_enhancer_tpu_torch.cmd.exporter \
        [--shim-source nvml|file:<path>] [--node-name local] \
        [--port 9400] [--collect-interval 15]

`--port 0` takes a free port; the line `ktwe-exporter up on :<port>`
names it. The JAX main's kube modes (`--kubeconfig`, `--in-cluster`,
`--api-server`) and its fake cluster discover a cluster's TPU nodes from
the API server: that is control-plane discovery, and it stays with the JAX
main.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..discovery.native_client import NativeGPUClient
from ..monitoring.exporter import ChipExporter, ExporterConfig


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ktwe-exporter")
    p.add_argument("--port", type=int, default=9400)
    p.add_argument("--collect-interval", type=float, default=15.0)
    p.add_argument("--shim-source", type=str, default="nvml",
                   help="'nvml' (the card's counters) or file:<path>")
    p.add_argument("--node-name", type=str, default="local")
    args = p.parse_args(argv)
    client = NativeGPUClient(args.node_name, args.shim_source)
    try:
        client.initialize()
    except ValueError as e:
        raise SystemExit(f"ktwe-exporter: {e}") from e
    exporter = ChipExporter(client, config=ExporterConfig(
        port=args.port, collect_interval_s=args.collect_interval))
    exporter.start()
    print(f"ktwe-exporter up on :{exporter.port}", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        stop.wait()
    finally:
        exporter.stop()
        client.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
