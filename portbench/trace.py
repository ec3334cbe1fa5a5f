"""The timed window, traced or not, and the reduction of its trace.

Untraced, the window is the host clock between its start and the moment
the device has finished its work.  Traced, ``torch.profiler`` records the
host's operations and the device's kernels and copies over the same
window, and ``Summary`` reduces them: the device's busy time (the union
of its kernel and copy intervals), the device operations by time, the
idle gaps by what the host was doing, and the kernels by name.
"""

from __future__ import annotations

import time
from collections import defaultdict

COPY_PREFIXES = ("Memcpy", "Memset")


class Summary:
    """A traced window's reduction (times in seconds)."""

    def __init__(self, window_s: float, busy_s: float, ops: dict,
                 gaps: dict, kernels: int, copies: int):
        self.window_s = window_s
        self.busy_s = busy_s
        self.ops = ops            # name -> [seconds, count]
        self.gaps = gaps          # host activity -> idle seconds
        self.kernels = kernels    # kernel intervals in the trace
        self.copies = copies      # copy and set intervals

    def kernel_time(self, match) -> tuple:
        """(seconds, count) of the device operations whose name ``match``
        accepts."""
        s = n = 0
        for name, (sec, cnt) in self.ops.items():
            if match(name):
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v[0]] for k, v in top],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _events(prof):
    """(host events, device events) as (start_ns, end_ns, name, thread)."""
    host, device = [], []
    kr = getattr(prof.profiler, "kineto_results", None)
    if kr is not None:
        for e in kr.events():
            start = e.start_ns()
            item = (start, start + e.duration_ns(), e.name(),
                    e.start_thread_id())
            (device if str(e.device_type()).endswith("CUDA")
             else host).append(item)
        return host, device
    for e in prof.events():
        item = (e.time_range.start * 1000, e.time_range.end * 1000, e.name,
                getattr(e, "thread", 0))
        (device if str(e.device_type).endswith("CUDA") else host).append(item)
    return host, device


def _union(intervals):
    """Merged [start, end] intervals of a list, in order."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host event (of the busiest thread)
    open at each gap's midpoint; "host code outside any operation" where
    none is."""
    out = defaultdict(float)
    if not gaps:
        return out
    threads = defaultdict(int)
    for h in host:
        threads[h[3]] += 1
    main = max(threads, key=threads.get) if threads else None
    events = sorted((h for h in host if h[3] == main and h[1] > h[0]),
                    key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in events]
    stack, k = [], 0
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) / 2
        while k < len(events) and starts[k] <= mid:
            while stack and stack[-1][1] < events[k][0]:
                stack.pop()
            stack.append(events[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "host code outside any operation"
        out[name] += (g1 - g0) / 1e9
    return out


def summarize(prof, window_s: float) -> Summary:
    host, device = _events(prof)
    ops = defaultdict(lambda: [0.0, 0])
    kernels = copies = 0
    for s, e, name, _ in device:
        ops[name][0] += (e - s) / 1e9
        ops[name][1] += 1
        if name.startswith(COPY_PREFIXES):
            copies += 1
        else:
            kernels += 1
    busy = _union([(s, e) for s, e, _, _ in device])
    busy_s = sum(e - s for s, e in busy) / 1e9
    if host or busy:
        lo = min([h[0] for h in host] + [b[0] for b in busy])
        hi = max([h[1] for h in host] + [b[1] for b in busy])
    else:
        lo = hi = 0
    edges = [lo] + [x for b in busy for x in b] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    return Summary(window_s, busy_s, dict(ops), dict(_label_gaps(gaps, host)),
                   kernels, copies)


class Window:
    """``with Window(traced, device) as w:`` around the timed work; then
    ``w.seconds`` and, traced, ``w.summary``."""

    def __init__(self, traced: bool, device):
        self.traced = traced
        self.device = device
        self.prof = None
        self.seconds = 0.0
        self.summary = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self.sync()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.sync()
        self.seconds = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.stop()
            if exc[0] is None:
                self.summary = summarize(self.prof, self.seconds)
            self.prof = None
        return False
