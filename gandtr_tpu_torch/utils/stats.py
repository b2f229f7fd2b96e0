"""Progress meters, timers, resource accounting, the code version and a
profiler trace (counterpart of gandtr_tpu/utils/stats.py; the reference's
mdir/tools/stats.py). The device memory comes from torch.cuda; `trace`
runs a block under torch.profiler.

    {"resource_usage": ResourceUsage(device).snapshot(),
     "code_version": CodeVersion().snapshot()}       # a stage's metadata
"""
import contextlib
import os
import subprocess
import sys
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


class AverageMeter:
    """A running average with progress lines on stderr (stats.py:12-45):
    every `print_each` updates and at `total`, the count, the average, the
    seconds an update and the minutes left."""

    def __init__(self, total=None, print_each=None, title=""):
        self.total = total
        self.print_each = print_each
        self.title = title
        self.reset()

    def reset(self):
        self.count = 0
        self.sum = 0.0
        self.start = time.time()

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def update(self, value, n=1):
        self.count += n
        self.sum += value * n
        if self.print_each and (self.count % self.print_each == 0 or
                                self.count == self.total):
            elapsed = time.time() - self.start
            per = elapsed / max(self.count, 1)
            eta = (self.total - self.count) * per if self.total else 0
            print(f"\r>> {self.title} {self.count}/{self.total or '?'} "
                  f"avg {self.avg:.4f} ({per:.2f}s/it, eta {eta / 60:.1f}min)",
                  end="", file=sys.stderr)
            if self.count == self.total:
                print("", file=sys.stderr)


class StopWatch:
    """Named laps (stats.py:48-68): `lap(name)` adds the time since the
    previous lap to that name's total; `emit(logger)` logs each total as a
    `scalar/time` event."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.laps = {}
        self._last = time.time()

    def lap(self, name):
        now = time.time()
        self.laps[name] = self.laps.get(name, 0.0) + (now - self._last)
        self._last = now
        return self.laps[name]

    def emit(self, logger, prefix="time"):
        for name, value in self.laps.items():
            logger(f"{prefix}/{name}", value, "scalar/time")


@contextlib.contextmanager
def trace(name, log_dir=None):
    """A block under torch.profiler (the CPU, and the card where there is
    one), its Chrome trace written to <log_dir>/<name>.trace.json; without
    `log_dir`, the block's wall time printed on stderr."""
    if not log_dir:
        t0 = time.time()
        yield
        print(f">> trace[{name}]: {time.time() - t0:.3f}s", file=sys.stderr)
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "%s.trace.json" % name))
