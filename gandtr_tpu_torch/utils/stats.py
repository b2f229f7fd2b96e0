"""Resource accounting and the code version
(counterpart of gandtr_tpu/utils/stats.py; the reference's
mdir/tools/stats.py). The device memory comes from torch.cuda.

    {"resource_usage": ResourceUsage(device).snapshot(),
     "code_version": CodeVersion().snapshot()}       # a stage's metadata
"""
import os
import subprocess
import time

import numpy as np
import torch


class ResourceUsage:
    """Wall seconds since construction, CPU seconds of the process, its
    resident memory, and on a CUDA device the memory torch holds there
    now and at its peak."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self._t0 = time.time()
        self._cpu0 = time.process_time()

    def snapshot(self):
        out = {"wall_seconds": time.time() - self._t0,
               "cpu_seconds": time.process_time() - self._cpu0}
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            out["ram_gb"] = pages * os.sysconf("SC_PAGE_SIZE") / 1e9
        except (OSError, ValueError, IndexError):
            pass
        if self.device is not None and self.device.type == "cuda":
            stats = torch.cuda.memory_stats(self.device)
            out["device_mem_gb"] = stats.get("allocated_bytes.all.current",
                                             0) / 1e9
            out["device_peak_mem_gb"] = \
                torch.cuda.max_memory_allocated(self.device) / 1e9
        return out


class CodeVersion:
    """The git head and dirty flag of the checkout, and the versions of
    torch and numpy."""

    def __init__(self, root=None):
        self.root = root or os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))

    def snapshot(self):
        out = {}
        try:
            out["git_head"] = subprocess.check_output(
                ["git", "rev-parse", "HEAD"], cwd=self.root,
                stderr=subprocess.DEVNULL).decode().strip()
            out["git_dirty"] = bool(subprocess.check_output(
                ["git", "status", "--porcelain"], cwd=self.root,
                stderr=subprocess.DEVNULL).decode().strip())
        except (OSError, subprocess.CalledProcessError):
            pass
        out["torch"] = torch.__version__
        out["numpy"] = np.__version__
        return out
