"""A GPU node's device layer: the counterpart of the JAX package's
discovery client seam. `GPUClient` (client.py) is the interface,
`NativeGPUClient` (native_client.py) reads NVML (nvml.py) or a metrics
table, `FakeGPUClient` (fakes.py) fabricates a node for dev mode."""
