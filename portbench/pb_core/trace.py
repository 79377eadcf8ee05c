"""A traced slice: ``torch.profiler`` over a steady stretch of a run,
reduced in memory to a summary (no trace file is written).

The harness marks its own host phases with ``record_function`` labels
named ``portbench.*``; the slice itself is ``portbench.slice``. The
summary gives the slice's length, the union of the device's activity
intervals inside it (never a sum of kernel times, which counts
overlapping kernels twice), the operations that took most device time,
the longest idle gaps named by what the host was doing, the intervals
of the kernels a metric asks for by name, and the device time of the
kernels launched under each host span.
"""

from __future__ import annotations

import re
import time
from contextlib import contextmanager
from typing import NamedTuple

SLICE = "portbench.slice"
DEVICE_ACTIVITIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
START_PAUSE_S = 0.05  # profiled, before the slice opens
# CUDA runtime and driver calls, by name where the profiler gives no
# activity type: cudaLaunchKernel, cudaGraphLaunch, cuLaunchKernelEx, ...
LAUNCH_NAME = re.compile(r"^cu(da)?[A-Z]")


class Dev(NamedTuple):
    """An operation on the device; `corr` is the correlation id it shares
    with the host call that launched it (0: none)."""
    start: int
    end: int
    name: str
    corr: int = 0


class Host(NamedTuple):
    """A host event: `kind` is "span" (a ``record_function`` label),
    "launch" (a CUDA runtime or driver call, `corr` its correlation id) or
    "op"; `tid` its thread."""
    start: int
    end: int
    name: str
    kind: str = "op"
    corr: int = 0
    tid: int = 0


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


def span_device_s(device, host, window) -> dict:
    """The device time of the kernels launched inside each host span, by
    span name, in seconds: the union of their intervals inside the slice.

    A kernel is matched to its launch by the correlation id the two share,
    never by overlap in time: a kernel runs after its launch has returned.
    The launch's innermost enclosing span on its thread takes the kernel.
    Every kernel replayed from a CUDA graph shares the graph launch's
    correlation id, so it counts under the span that encloses that launch:
    the layers of a decode burst replayed from a graph cannot be told
    apart."""
    w0, w1 = window
    spans = [h for h in host if h.kind == "span"]
    launches = {h.corr: h for h in host if h.kind == "launch" and h.corr}
    owner: dict[int, str | None] = {}
    under: dict[str, list] = {}
    for d in device:
        if not d.corr or d.end <= w0 or d.start >= w1:
            continue
        if d.corr not in owner:
            launch, best = launches.get(d.corr), None
            for sp in spans if launch else ():
                if (sp.tid == launch.tid and sp.start <= launch.start < sp.end
                        and (best is None or (sp.start, -sp.end) > (best.start, -best.end))):
                    best = sp
            owner[d.corr] = best.name if best else None
        name = owner[d.corr]
        if name is not None:
            under.setdefault(name, []).append((max(d.start, w0), min(d.end, w1)))
    return {name: sum(e - s for s, e in merge(iv)) / 1e9 for name, iv in under.items()}


def summarize(device, host, window, kernel_patterns=None, top: int = 10) -> dict:
    """Reduce a slice's events to its summary.

    device: `Dev` (or (start_ns, end_ns, name)) of every device activity;
    host: `Host` (or (start_ns, end_ns, name)) of host events (labels,
    operators, runtime calls); window: (start_ns, end_ns) of the slice.
    Times in the summary are seconds."""
    device = [Dev(*d) for d in device]
    host = [Host(*h) for h in host]
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1)) for s, e, *_ in device if e > w0 and s < w1]
    busy = merge(clipped)
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict[str, int] = {}
    for s, e, name, _ in device:
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
    labels = [(s, e, n) for s, e, n, *_ in host if n.startswith("portbench.") and n != SLICE]
    ops = [(s, e, n) for s, e, n, *_ in host if not n.startswith("portbench.")]

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
        kernels[key] = sorted((s / 1e9, (e - s) / 1e9) for s, e, n, _ in device
                              if rx.search(n) and e > w0 and s < w1)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_ns / 1e9,
        "device_ops": [[n, ns / 1e9] for n, ns in device_ops],
        "idle_gaps": idle_gaps,
        "kernels": kernels,
        "span_device_s": span_device_s(device, host, window),
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


def _host_kind(ev) -> str:
    """A host event's kind for `Host`: a ``record_function`` label, a CUDA
    runtime or driver call, or any other operation."""
    kind = getattr(ev, "activity_type", None)
    kind = kind() if kind is not None else None
    is_label = getattr(ev, "is_user_annotation", None)
    if kind == "user_annotation" or (is_label is not None and is_label()) \
            or ev.name().startswith("portbench."):
        return "span"
    if kind in ("cuda_runtime", "cuda_driver") or (kind is None and LAUNCH_NAME.match(ev.name())):
        return "launch"
    return "op"


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
            # Kernels launched in the profiler's first moments can go
            # unrecorded (on the H100: up to 235 of a slice's first kernels
            # in 1 slice of 25); the slice opens after a pause.
            time.sleep(START_PAUSE_S)
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
                    device.append(Dev(*span, ev.correlation_id()))
            else:
                kind = _host_kind(ev)
                host.append(Host(*span, kind, ev.correlation_id() if kind == "launch" else 0,
                                 ev.start_thread_id()))
                if ev.name() == SLICE:
                    window = span[:2]
        if window is None:
            raise RuntimeError("the profiler recorded no slice label")
        out = summarize(device, host, window, kernel_patterns)
        out["device_event_kinds"] = kinds
        return out
