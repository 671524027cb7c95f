"""Run a checkout's chip_smoke.py with gc.collect() before every peak-memory
reset, the way chip_smoke.py itself reads its training peaks: for reading
the peaks of an older checkout whose script does not collect first, so
that memory held only by reference cycles from its earlier phases is not
counted. Needs a CUDA card, like chip_smoke.py. Imports torch only.

    cd <checkout> && python3 <path to this file>
"""

import gc
import os
import runpy
import sys

import torch

_reset = torch.cuda.reset_peak_memory_stats


def _collect_then_reset(*args, **kwargs):
    gc.collect()
    torch.cuda.empty_cache()
    _reset(*args, **kwargs)


if __name__ == "__main__":
    torch.cuda.reset_peak_memory_stats = _collect_then_reset
    sys.path.insert(0, os.getcwd())
    sys.argv = ["chip_smoke.py"]
    runpy.run_path("chip_smoke.py", run_name="__main__")
