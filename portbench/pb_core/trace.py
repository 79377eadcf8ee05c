"""A traced slice: ``torch.profiler`` over a steady stretch of a run,
reduced in memory to a summary (no trace file is written).

The harness marks its own host phases with ``record_function`` labels
named ``portbench.*``; the slice itself is ``portbench.slice``. The
summary gives the slice's length, the union of the device's activity
intervals inside it (never a sum of kernel times, which counts
overlapping kernels twice), the operations that took most device time,
the longest idle gaps named by what the host was doing, and the
intervals of the kernels a metric asks for by name.
"""

from __future__ import annotations

import re
from contextlib import contextmanager

SLICE = "portbench.slice"
DEVICE_ACTIVITIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)", "(anon)")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and not name.startswith("(anon)", i):
            cut = i
            break
    return name[:cut][:width]


def merge(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def summarize(device, host, window, kernel_patterns=None, top: int = 10) -> dict:
    """Reduce a slice's events to its summary.

    device: (start_ns, end_ns, name) of every device activity; host:
    (start_ns, end_ns, name) of host events (labels and operators);
    window: (start_ns, end_ns) of the slice. Times in the summary are
    seconds."""
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for s, e, _ in device if e > w0 and s < w1]
    busy = merge(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, int] = {}
    for s, e, name in device:
        if e > w0 and s < w1:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0) + (min(e, w1) - max(s, w0))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    gaps, cursor = [], w0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < w1:
        gaps.append((cursor, w1))
    labels = [(s, e, n) for s, e, n in host if n.startswith("portbench.") and n != SLICE]
    ops = [(s, e, n) for s, e, n in host if not n.startswith("portbench.")]

    def innermost(events, t):
        best = None
        for s, e, n in events:
            if s <= t < e and (best is None or s >= best[0]):
                best = (s, e, n)
        return best[2] if best else None

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    idle_gaps = []
    for s, e in longest:
        label = innermost(labels, s) or "portbench.other"
        op = innermost(ops, s)
        idle_gaps.append([f"{label}:{op}" if op else label, (e - s) / 1e9])

    kernels = {}
    for key, pattern in (kernel_patterns or {}).items():
        rx = re.compile(pattern)
        kernels[key] = sorted((s / 1e9, (e - s) / 1e9) for s, e, n in device
                              if rx.search(n) and e > w0 and s < w1)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n, ns / 1e9] for n, ns in device_ops],
        "idle_gaps": idle_gaps,
        "kernels": kernels,
    }


def _kind(ev) -> str:
    """A device event's activity type. The card's torch (2.11) has no
    activity_type() on its events: there a label's device-side copy is a
    user annotation (or carries a portbench.* name), and any other named
    event is an operation."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind()
    is_label = getattr(ev, "is_user_annotation", None)
    if (is_label is not None and is_label()) or ev.name().startswith("portbench."):
        return "gpu_user_annotation"
    return "kernel" if ev.name() else "unnamed"


class Tracer:
    """Profiles one slice per run, when enabled; labels cost nothing when
    the profiler is off."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.summary = None
        self._prof = None

    @contextmanager
    def label(self, name: str):
        if self._prof is None:
            yield
            return
        with self.torch.profiler.record_function(name):
            yield

    @contextmanager
    def slice(self, kernel_patterns=None):
        """Profile the block (device and host), then summarize it."""
        if not self.enabled:
            yield
            return
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize() if torch.cuda.is_available() else None
        prof = profile(activities=acts)
        prof.__enter__()
        self._prof = prof
        try:
            with torch.profiler.record_function(SLICE):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self._prof = None
            prof.__exit__(None, None, None)
        self.summary = self._reduce(prof, kernel_patterns)

    def _reduce(self, prof, kernel_patterns):
        cuda = self.torch.autograd.DeviceType.CUDA
        device, host, window, kinds = [], [], None, {}
        for ev in prof.profiler.kineto_results.events():
            span = (ev.start_ns(), ev.end_ns(), ev.name())
            if ev.device_type() == cuda:
                kind = _kind(ev)
                n, secs = kinds.get(kind, (0, 0.0))
                kinds[kind] = (n + 1, secs + (span[1] - span[0]) / 1e9)
                # Operations that ran on the device; the device-side copies
                # of the host's labels are not.
                if kind in DEVICE_ACTIVITIES:
                    device.append(span)
            else:
                host.append(span)
                if ev.name() == SLICE:
                    window = span[:2]
        if window is None:
            raise RuntimeError("the profiler recorded no slice label")
        out = summarize(device, host, window, kernel_patterns)
        out["device_event_kinds"] = kinds
        return out
