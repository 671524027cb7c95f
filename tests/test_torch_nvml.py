"""The port's NVML bindings (discovery/nvml.py) and the client's `nvml`
source, held on the CPU against a stand-in `libnvidia-ml`: a short C
source below, compiled with `cc` into the test's temporary directory and
loaded through the module's library-path parameter (or, for the mains'
default path, put in the module's cache of loaded libraries under that
name). The stand-in serves the bound calls with values a test sets,
counts nvmlInit_v2 / nvmlShutdown, refuses a handle it did not give out,
and answers a chosen nvmlReturn_t for a chosen call of a chosen device.

- every field of a sample and the unit conversions (bytes over 2^30, mW
  over 1000), device memory past 4 GiB (64-bit fields);
- two devices, found by UUID (NVML's index is PCI order, not CUDA's);
- a lost GPU is unhealthy with NVML's text, the other device read;
- any other error raises NvmlError with its code and text, from a read,
  from init and from a missing library;
- every init is paired with a shutdown: the client, auto's probe in the
  agent main, a failed count;
- importing the port's device layer and its mains loads no library.
"""

import ctypes
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from k8s_gpu_workload_enhancer_tpu_torch.cmd import agent as agent_main
from k8s_gpu_workload_enhancer_tpu_torch.discovery import nvml
from k8s_gpu_workload_enhancer_tpu_torch.discovery.native_client import \
    NativeGPUClient
from k8s_gpu_workload_enhancer_tpu_torch.discovery.types import HealthStatus
from k8s_gpu_workload_enhancer_tpu_torch.monitoring.exporter import \
    ChipExporter

import torch_parity  # noqa: F401  (one intra-op thread a process)

FAKE_NVML_C = r"""
#include <string.h>

typedef struct { unsigned int gpu, memory; } nvmlUtilization_t;
typedef struct { unsigned long long total, free, used; } nvmlMemory_t;
typedef struct { int index; } dev_t_;
typedef dev_t_ *nvmlDevice_t;

#define MAXD 4
static dev_t_ devs[MAXD] = {{0}, {1}, {2}, {3}};
static unsigned count, util_gpu[MAXD], util_mem[MAXD], power[MAXD],
    limit[MAXD], temp[MAXD];
static unsigned long long total[MAXD], used[MAXD];
static char uuid[MAXD][96], name[MAXD][96], fail_call[MAXD][64];
static int fail_rc[MAXD], init_rc, inits, shutdowns, refs;

void fake_reset(void) {
  memset(fail_call, 0, sizeof fail_call);
  memset(fail_rc, 0, sizeof fail_rc);
  count = init_rc = inits = shutdowns = refs = 0;
}
void fake_set_count(unsigned n) { count = n; }
void fake_set_init_rc(int rc) { init_rc = rc; }
int fake_inits(void) { return inits; }
int fake_shutdowns(void) { return shutdowns; }
void fake_set_device(int i, unsigned g, unsigned m, unsigned long long t,
                     unsigned long long u, unsigned p, unsigned l,
                     unsigned c, const char *id, const char *nm) {
  util_gpu[i] = g; util_mem[i] = m; total[i] = t; used[i] = u;
  power[i] = p; limit[i] = l; temp[i] = c;
  strncpy(uuid[i], id, 95); strncpy(name[i], nm, 95);
}
void fake_fail(int i, const char *call, int rc) {
  strncpy(fail_call[i], call, 63); fail_rc[i] = rc;
}

static int check(nvmlDevice_t d, const char *call) {
  if (!refs) return 1;                               /* Uninitialized */
  if (d < devs || d >= devs + MAXD) return 2;        /* Invalid Argument */
  if (fail_rc[d->index] && !strcmp(fail_call[d->index], call))
    return fail_rc[d->index];
  return 0;
}

int nvmlInit_v2(void) {
  if (init_rc) return init_rc;
  inits++; refs++; return 0;
}
int nvmlShutdown(void) {
  if (!refs) return 1;
  shutdowns++; refs--; return 0;
}
int nvmlDeviceGetCount_v2(unsigned *n) {
  if (!refs) return 1;
  *n = count; return 0;
}
int nvmlDeviceGetHandleByIndex_v2(unsigned i, nvmlDevice_t *d) {
  if (!refs) return 1;
  if (i >= count) return 2;
  int rc = check(&devs[i], "nvmlDeviceGetHandleByIndex_v2");
  if (rc) return rc;
  *d = &devs[i]; return 0;
}
int nvmlDeviceGetUUID(nvmlDevice_t d, char *buf, unsigned n) {
  int rc = check(d, "nvmlDeviceGetUUID");
  if (rc) return rc;
  if (n < 96) return 7;                              /* Insufficient Size */
  strncpy(buf, uuid[d->index], n); return 0;
}
int nvmlDeviceGetName(nvmlDevice_t d, char *buf, unsigned n) {
  int rc = check(d, "nvmlDeviceGetName");
  if (rc) return rc;
  if (n < 96) return 7;
  strncpy(buf, name[d->index], n); return 0;
}
int nvmlDeviceGetUtilizationRates(nvmlDevice_t d, nvmlUtilization_t *u) {
  int rc = check(d, "nvmlDeviceGetUtilizationRates");
  if (rc) return rc;
  u->gpu = util_gpu[d->index]; u->memory = util_mem[d->index]; return 0;
}
int nvmlDeviceGetMemoryInfo(nvmlDevice_t d, nvmlMemory_t *m) {
  int rc = check(d, "nvmlDeviceGetMemoryInfo");
  if (rc) return rc;
  m->total = total[d->index]; m->used = used[d->index];
  m->free = total[d->index] - used[d->index]; return 0;
}
int nvmlDeviceGetPowerUsage(nvmlDevice_t d, unsigned *p) {
  int rc = check(d, "nvmlDeviceGetPowerUsage");
  if (rc) return rc;
  *p = power[d->index]; return 0;
}
int nvmlDeviceGetPowerManagementLimit(nvmlDevice_t d, unsigned *p) {
  int rc = check(d, "nvmlDeviceGetPowerManagementLimit");
  if (rc) return rc;
  *p = limit[d->index]; return 0;
}
int nvmlDeviceGetTemperature(nvmlDevice_t d, int sensor, unsigned *t) {
  int rc = check(d, "nvmlDeviceGetTemperature");
  if (rc) return rc;
  if (sensor != 0) return 2;
  *t = temp[d->index]; return 0;
}
const char *nvmlErrorString(int rc) {
  switch (rc) {
    case 0: return "Success";
    case 1: return "Uninitialized";
    case 2: return "Invalid Argument";
    case 3: return "Not Supported";
    case 7: return "Insufficient Size";
    case 9: return "Driver Not Loaded";
    case 15: return "GPU is lost";
    default: return "Unknown Error";
  }
}
"""

ROOT = pathlib.Path(__file__).resolve().parent.parent
GIB = 1 << 30
DEV_A = dict(g=93, m=41, t=80 * GIB + 123 * (1 << 20), u=5 * GIB + 7,
            p=312_345, l=700_000, c=47, id="GPU-aaaa-0000", nm="Card A")
DEV_B = dict(g=40, m=3, t=80 * GIB, u=GIB // 2, p=95_000, l=700_000, c=38,
            id="GPU-bbbb-1111", nm="Card B")


@pytest.fixture(scope="module")
def fake_path(tmp_path_factory):
    cc = shutil.which("cc")
    if cc is None:
        pytest.skip("no C compiler (cc) to build the stand-in NVML")
    d = tmp_path_factory.mktemp("fake_nvml")
    src = d / "fake_nvml.c"
    src.write_text(FAKE_NVML_C)
    out = d / "libnvidia-ml-fake.so"
    subprocess.run([cc, "-shared", "-fPIC", "-O1", "-o", str(out), str(src)],
                   check=True, capture_output=True, timeout=60)
    return str(out)


@pytest.fixture
def fake(fake_path):
    lib = ctypes.CDLL(fake_path)      # the same handle nvml.load opens
    lib.fake_set_device.argtypes = [
        ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_ulonglong,
        ctypes.c_ulonglong, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_char_p, ctypes.c_char_p]
    lib.fake_fail.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.fake_reset()

    def device(i, d):
        lib.fake_set_device(i, d["g"], d["m"], d["t"], d["u"], d["p"],
                            d["l"], d["c"], d["id"].encode(),
                            d["nm"].encode())

    lib.device = device
    lib.path = fake_path
    yield lib
    lib.fake_reset()


def test_sample_fields_and_units(fake):
    fake.fake_set_count(1)
    fake.device(0, DEV_A)
    with nvml.Session(fake.path) as s:
        assert s.device_count() == 1
        h = s.handle(0)
        assert s.uuid(h) == DEV_A["id"] and s.name(h) == DEV_A["nm"]
        assert s.utilization(h) == (DEV_A["g"], DEV_A["m"])
        assert s.memory(h) == (DEV_A["t"], DEV_A["t"] - DEV_A["u"], DEV_A["u"])
        assert s.power_mw(h) == DEV_A["p"]
        assert s.power_limit_mw(h) == DEV_A["l"]
        assert s.temperature_c(h) == DEV_A["c"]
        sample = s.sample(0)
    assert sample == nvml.ChipSample(
        index=0, duty_cycle_pct=93.0, tensorcore_util_pct=0.0,
        hbm_used_gb=DEV_A["u"] / 2**30, hbm_total_gb=DEV_A["t"] / 2**30,
        power_watts=312.345, temperature_c=47.0, health=0)
    assert [f for f in nvml.ChipSample.__dataclass_fields__] == [
        "index", "duty_cycle_pct", "tensorcore_util_pct", "hbm_used_gb",
        "hbm_total_gb", "power_watts", "temperature_c", "health"]
    client = NativeGPUClient("n", "nvml", nvml_path=fake.path)
    client.initialize()
    try:
        u = client.get_utilization("n")["n-chip-0"]
        h = client.get_health("n")["n-chip-0"]
    finally:
        client.shutdown()
    assert (u.duty_cycle_pct, u.tensorcore_util_pct, u.hbm_used_gb,
            u.hbm_total_gb, u.power_watts, u.temperature_c) == (
        93.0, 0.0, DEV_A["u"] / 2**30, 80 + 123 / 1024, 312.345, 47.0)
    assert h.status == HealthStatus.HEALTHY and h.reasons == []
    assert h.temperature_c == 47.0
    with pytest.raises(KeyError):
        client.get_utilization("other")


def test_two_devices_are_found_by_uuid(fake):
    fake.fake_set_count(2)
    fake.device(0, DEV_A)
    fake.device(1, DEV_B)
    with nvml.Session(fake.path) as s:
        by_uuid = {s.uuid(s.handle(i)): i for i in range(s.device_count())}
        assert by_uuid == {DEV_A["id"]: 0, DEV_B["id"]: 1}
        b = by_uuid[DEV_B["id"]]
        assert s.name(s.handle(b)) == DEV_B["nm"]
        assert s.sample(b).duty_cycle_pct == 40.0
    client = NativeGPUClient("n", "nvml", nvml_path=fake.path)
    client.initialize()
    try:
        utils = client.get_utilization("n")
    finally:
        client.shutdown()
    assert sorted(utils) == ["n-chip-0", "n-chip-1"]
    assert utils[f"n-chip-{b}"].hbm_used_gb == 0.5
    assert utils[f"n-chip-{b}"].power_watts == 95.0


def test_a_lost_gpu_is_unhealthy_with_nvmls_text(fake):
    fake.fake_set_count(2)
    fake.device(0, DEV_A)
    fake.device(1, DEV_B)
    fake.fake_fail(1, b"nvmlDeviceGetUtilizationRates", 15)
    client = NativeGPUClient("n", "nvml", nvml_path=fake.path)
    client.initialize()
    try:
        health = client.get_health("n")
        utils = client.get_utilization("n")
        exporter = ChipExporter(client)
        exporter.collect_once()
        text = exporter.render().decode()
    finally:
        client.shutdown()
    assert health["n-chip-1"].status == HealthStatus.UNHEALTHY
    assert health["n-chip-1"].reasons == ["GPU is lost"]
    assert health["n-chip-0"].status == HealthStatus.HEALTHY
    assert utils["n-chip-1"].duty_cycle_pct == 0.0
    assert utils["n-chip-0"].duty_cycle_pct == 93.0
    assert 'ktwe_chip_healthy{node="n",chip="n-chip-1"} 0.0' in text
    assert 'ktwe_cluster_chips_total{state="unhealthy"} 1.0' in text
    fake.fake_fail(1, b"nvmlDeviceGetHandleByIndex_v2", 15)
    with nvml.Session(fake.path) as s, pytest.raises(nvml.NvmlError) as e:
        s.sample(1)
    assert e.value.code == nvml.NVML_ERROR_GPU_IS_LOST


@pytest.mark.parametrize("call", ["nvmlDeviceGetPowerUsage",
                                  "nvmlDeviceGetMemoryInfo",
                                  "nvmlDeviceGetTemperature"])
def test_any_other_error_raises_with_its_text(fake, call):
    fake.fake_set_count(1)
    fake.device(0, DEV_A)
    fake.fake_fail(0, call.encode(), 3)
    client = NativeGPUClient("n", "nvml", nvml_path=fake.path)
    client.initialize()
    try:
        for read in (client.get_utilization, client.get_health):
            with pytest.raises(nvml.NvmlError) as e:
                read("n")
            assert (e.value.code, e.value.text, e.value.call) == (
                3, "Not Supported", call)
            assert "Not Supported" in str(e.value)
    finally:
        client.shutdown()
    assert fake.fake_inits() == fake.fake_shutdowns() == 1


def test_init_and_library_failures_raise_nvmls_text(fake, tmp_path):
    fake.fake_set_init_rc(9)
    with pytest.raises(nvml.NvmlError, match="Driver Not Loaded") as e:
        NativeGPUClient("n", "nvml", nvml_path=fake.path).initialize()
    assert (e.value.code, e.value.call) == (9, "nvmlInit_v2")
    missing = str(tmp_path / "libnvidia-ml.so.1")
    with pytest.raises(nvml.NvmlError,
                       match="NVML Shared Library Not Found") as e:
        nvml.Session(missing)
    assert e.value.code == nvml.NVML_ERROR_LIBRARY_NOT_FOUND
    with pytest.raises(nvml.NvmlError, match="Not Found"):
        NativeGPUClient("n", "nvml", nvml_path=missing).initialize()
    with pytest.raises(RuntimeError, match="not initialized"):
        NativeGPUClient("n", "nvml", nvml_path=fake.path).get_utilization("n")


def test_every_init_is_paired_with_a_shutdown(fake, monkeypatch, tmp_path):
    fake.fake_set_count(1)
    fake.device(0, DEV_A)
    client = NativeGPUClient("n", "nvml", nvml_path=fake.path)
    client.initialize()
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (1, 0)
    client.get_utilization("n")
    client.initialize()                 # closes the first session
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (2, 1)
    client.shutdown()
    client.shutdown()                   # a second shutdown does nothing
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (2, 2)
    # The agent main's auto probe, with the stand-in as the driver's library.
    monkeypatch.setitem(nvml._libs, nvml.DEFAULT_PATH, nvml.load(fake.path))
    table = tmp_path / "chip-metrics"
    table.write_text("0 91.5 85.0 12.5 16.0 170.0 55.0 0\n")
    args = agent_main.build_parser().parse_args(
        ["--node-name", "n", "--file-table", str(table)])
    assert agent_main.choose_source(args) == "nvml"
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (3, 3)
    fake.fake_set_count(0)              # NVML answers but sees no card
    assert agent_main.choose_source(args) == f"file:{table}"
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (4, 4)
    fake.fake_set_init_rc(9)            # init fails: nothing to pair
    assert agent_main.choose_source(args) == f"file:{table}"
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (4, 4)
    fake.fake_set_init_rc(0)
    fake.fake_set_count(1)
    explicit = agent_main.build_parser().parse_args(
        ["--node-name", "n", "--shim-source", "nvml"])
    assert agent_main.choose_source(explicit) == "nvml"
    assert (fake.fake_inits(), fake.fake_shutdowns()) == (4, 4)


def test_importing_the_device_layer_loads_no_library():
    code = textwrap.dedent("""
        import ctypes
        opened = []
        class Spy(ctypes.CDLL):
            def __init__(self, name, *a, **k):
                opened.append(str(name))
                super().__init__(name, *a, **k)
        ctypes.CDLL = Spy
        import k8s_gpu_workload_enhancer_tpu_torch.discovery.nvml as nvml
        import k8s_gpu_workload_enhancer_tpu_torch.discovery.native_client
        import k8s_gpu_workload_enhancer_tpu_torch.discovery.fakes
        import k8s_gpu_workload_enhancer_tpu_torch.agent.agent
        import k8s_gpu_workload_enhancer_tpu_torch.monitoring.exporter
        import k8s_gpu_workload_enhancer_tpu_torch.cmd.agent
        import k8s_gpu_workload_enhancer_tpu_torch.cmd.exporter
        assert nvml._libs == {}, nvml._libs
        assert not [n for n in opened if "nvidia-ml" in n], opened
        with open("/proc/self/maps") as f:
            assert "nvidia-ml" not in f.read()
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
