"""Process collector: host-process health for the node the pager runs on.

Reads ``/proc/self`` and ``os.times()`` only — no psutil dependency, no
locks.  On platforms without procfs the memory/fd families are simply
omitted (collectors return what they can measure).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from ..metrics import MetricFamily
from .base import Collector


def _proc_status() -> dict:
    out = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(("VmRSS:", "VmSize:", "Threads:")):
                    key, val = line.split(":", 1)
                    out[key] = int(val.split()[0])
    except (OSError, ValueError):
        pass
    return out


class ProcessCollector(Collector):
    kind = "process"

    def __init__(self, label: Optional[str] = None):
        super().__init__(label)
        self._started = time.time()

    def collect(self) -> List[MetricFamily]:
        fams: List[MetricFamily] = []
        status = _proc_status()
        if "VmRSS" in status:
            fams.append(self.g1("umap_process_resident_memory_bytes",
                                "Resident set size", status["VmRSS"] * 1024))
        if "VmSize" in status:
            fams.append(self.g1("umap_process_virtual_memory_bytes",
                                "Virtual memory size", status["VmSize"] * 1024))
        fams.append(self.g1(
            "umap_process_threads", "Live threads",
            status.get("Threads", threading.active_count())))
        try:
            nfds = len(os.listdir("/proc/self/fd"))
        except OSError:
            nfds = None
        if nfds is not None:
            fams.append(self.g1("umap_process_open_fds",
                                "Open file descriptors", nfds))
        t = os.times()
        fams += [
            self.c1("umap_process_cpu_seconds_total",
                    "User + system CPU time", t.user + t.system),
            self.g1("umap_process_uptime_seconds",
                    "Seconds since this collector was created",
                    time.time() - self._started),
        ]
        return fams
