"""ctypes bindings on NVIDIA's management library, `libnvidia-ml.so.1`,
which the card's driver installs: the GPU node's counterpart of the JAX
package's device shim surface (native/bindings.py `shim_open` /
`shim_read`) and of its libtpu reader (native/libtpu_grpc.cc).

The library is loaded at first use, never when this module is imported,
under a lock (the lazy load is not thread-safe; NVML itself is). `load`
takes the library's path as a parameter, so a test can load a stand-in.
Every function bound here has its `argtypes` and `restype` declared: a
default `int` return or an undeclared pointer argument would pass on a
stand-in and corrupt on the card. The structures and constants are held
to the CUDA toolkit's `nvml.h` by `chip_smoke.py` (its `nvml` phase
compiles a probe of their sizes, offsets and values against the header).

`nvmlInit_v2` and `nvmlShutdown` are reference-counted by NVML: every
`Session` pairs them, as the JAX agent pairs `shim_open` / `shim_close`.
A missing library or a failed call raises `NvmlError` with NVML's own
text; nothing here falls back to another source.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

DEFAULT_PATH = "libnvidia-ml.so.1"

# nvmlReturn_t values and the other constants of nvml.h used here.
NVML_SUCCESS = 0
NVML_ERROR_LIBRARY_NOT_FOUND = 12
NVML_ERROR_FUNCTION_NOT_FOUND = 13
NVML_ERROR_GPU_IS_LOST = 15
NVML_TEMPERATURE_GPU = 0
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96
NVML_DEVICE_NAME_V2_BUFFER_SIZE = 96

CONSTANTS = {name: value for name, value in globals().items()
             if name.startswith("NVML_")}

_BYTES_PER_GIB = float(1 << 30)


class Utilization(ctypes.Structure):
    """nvmlUtilization_t: percent of the last sample period."""
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Memory(ctypes.Structure):
    """nvmlMemory_t: bytes."""
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


# C name -> ctypes structure, for the check against nvml.h.
STRUCTS = {"nvmlUtilization_t": Utilization, "nvmlMemory_t": Memory}

_UINT_P = ctypes.POINTER(ctypes.c_uint)
_HANDLE = ctypes.c_void_p                      # nvmlDevice_t
_PROTOTYPES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_UINT_P],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                      ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetUtilizationRates": [_HANDLE, ctypes.POINTER(Utilization)],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, ctypes.POINTER(Memory)],
    "nvmlDeviceGetPowerUsage": [_HANDLE, _UINT_P],
    "nvmlDeviceGetPowerManagementLimit": [_HANDLE, _UINT_P],
    "nvmlDeviceGetTemperature": [_HANDLE, ctypes.c_int, _UINT_P],
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class NvmlError(RuntimeError):
    """A call that did not answer NVML_SUCCESS: `code` is its
    nvmlReturn_t, `text` NVML's nvmlErrorString of it."""

    def __init__(self, code: int, text: str, call: str = ""):
        super().__init__(f"{call}: {text} (nvmlReturn_t {code})" if call
                         else f"{text} (nvmlReturn_t {code})")
        self.code = code
        self.text = text
        self.call = call


@dataclass
class ChipSample:
    """One device's counters, the fields of the JAX shim's
    `ktwe_chip_sample` in its order. `health` is 0 healthy, 1 degraded,
    2 unhealthy."""

    index: int
    duty_cycle_pct: float = 0.0
    tensorcore_util_pct: float = 0.0
    hbm_used_gb: float = 0.0
    hbm_total_gb: float = 0.0
    power_watts: float = 0.0
    temperature_c: float = 0.0
    health: int = 0


def load(path: str = DEFAULT_PATH) -> ctypes.CDLL:
    """The library at `path` with every prototype declared; loaded once a
    path. Raises NvmlError (library not found, function not found)."""
    with _lock:
        lib = _libs.get(path)
        if lib is not None:
            return lib
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NvmlError(NVML_ERROR_LIBRARY_NOT_FOUND,
                            f"NVML Shared Library Not Found ({e})",
                            "load") from e
        try:
            for name, argtypes in _PROTOTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nvmlErrorString.argtypes = [ctypes.c_int]
            lib.nvmlErrorString.restype = ctypes.c_char_p
        except AttributeError as e:
            raise NvmlError(NVML_ERROR_FUNCTION_NOT_FOUND,
                            f"Function Not Found ({e})", "load") from e
        _libs[path] = lib
        return lib


class Session:
    """One nvmlInit_v2 on the library at `path`, paired with one
    nvmlShutdown by `close` (or the `with` block)."""

    def __init__(self, path: str = DEFAULT_PATH):
        self._lib = load(path)
        self._open = False
        self._check("nvmlInit_v2", self._lib.nvmlInit_v2())
        self._open = True

    def close(self) -> None:
        if self._open:
            self._open = False
            self._check("nvmlShutdown", self._lib.nvmlShutdown())

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _check(self, call: str, rc: int) -> None:
        if rc != NVML_SUCCESS:
            text = self._lib.nvmlErrorString(rc)
            raise NvmlError(rc, text.decode(errors="replace") if text
                            else "unknown error", call)

    def _uint(self, call: str, *args) -> int:
        out = ctypes.c_uint()
        self._check(call, getattr(self._lib, call)(*args, ctypes.byref(out)))
        return out.value

    def _text(self, call: str, handle, size: int) -> str:
        buf = ctypes.create_string_buffer(size)
        self._check(call, getattr(self._lib, call)(handle, buf, size))
        return buf.value.decode(errors="replace")

    def device_count(self) -> int:
        return self._uint("nvmlDeviceGetCount_v2")

    def handle(self, index: int) -> ctypes.c_void_p:
        out = _HANDLE()
        self._check("nvmlDeviceGetHandleByIndex_v2",
                    self._lib.nvmlDeviceGetHandleByIndex_v2(
                        index, ctypes.byref(out)))
        return out

    def uuid(self, handle) -> str:
        return self._text("nvmlDeviceGetUUID", handle,
                          NVML_DEVICE_UUID_V2_BUFFER_SIZE)

    def name(self, handle) -> str:
        return self._text("nvmlDeviceGetName", handle,
                          NVML_DEVICE_NAME_V2_BUFFER_SIZE)

    def utilization(self, handle) -> Tuple[int, int]:
        """(gpu, memory) percent of the last sample period."""
        out = Utilization()
        self._check("nvmlDeviceGetUtilizationRates",
                    self._lib.nvmlDeviceGetUtilizationRates(
                        handle, ctypes.byref(out)))
        return out.gpu, out.memory

    def memory(self, handle) -> Tuple[int, int, int]:
        """(total, free, used) bytes."""
        out = Memory()
        self._check("nvmlDeviceGetMemoryInfo",
                    self._lib.nvmlDeviceGetMemoryInfo(handle,
                                                      ctypes.byref(out)))
        return out.total, out.free, out.used

    def power_mw(self, handle) -> int:
        return self._uint("nvmlDeviceGetPowerUsage", handle)

    def power_limit_mw(self, handle) -> int:
        return self._uint("nvmlDeviceGetPowerManagementLimit", handle)

    def temperature_c(self, handle) -> int:
        return self._uint("nvmlDeviceGetTemperature", handle,
                          NVML_TEMPERATURE_GPU)

    def sample(self, index: int) -> ChipSample:
        """Every counter of device `index` (NVML's order, which is PCI
        order and ignores CUDA_VISIBLE_DEVICES); health 0 when every query
        answers, as a responsive libtpu runtime reads. A query that fails
        raises NvmlError."""
        h = self.handle(index)
        gpu, _ = self.utilization(h)
        total, _, used = self.memory(h)
        return ChipSample(
            index=index, duty_cycle_pct=float(gpu), tensorcore_util_pct=0.0,
            hbm_used_gb=used / _BYTES_PER_GIB,
            hbm_total_gb=total / _BYTES_PER_GIB,
            power_watts=self.power_mw(h) / 1000.0,
            temperature_c=float(self.temperature_c(h)), health=0)
