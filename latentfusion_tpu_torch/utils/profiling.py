"""Profiling helpers (counterpart of ``latentfusion_tpu/utils/profiling.py``).

``profile`` traces a region with ``torch.profiler`` (CPU ops and, on a CUDA
device, the device's kernels and copies) and writes a Chrome trace;
``measure_time`` and ``timeit`` are synchronized wall-clock timers;
``elapsed_ms`` brackets one call with CUDA events; ``top_ops`` sums time and
launches by op name, from a written trace or a live profile, and prints the
table the JAX package's ``tools/profile_refinement.py`` prints;
``device_ms`` and ``device_busy`` read a live profile's device lane.

Which lane a reader takes follows the device its caller names: on ``cuda``
the device's kernels, copies and sets (``DEVICE_CATEGORIES``), each by its
duration; on ``cpu`` the host's events, each by its self time (its
duration less that of the events nested in it on its thread).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import json
import logging
import sys
import time
from pathlib import Path
from typing import NamedTuple

import torch
from torch.autograd import DeviceType

from ..device import resolve_device, synchronize

logger = logging.getLogger(__name__)

# The Chrome trace categories of work on the device's lane.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_GLOB = "trace-*.json"
# The span a written trace adds around the whole traced region.
PROFILER_SPAN = "PyTorch Profiler"


@contextlib.contextmanager
def profile(log_dir=None, device="cuda", profile_memory: bool = False):
    """Trace the enclosed region; yields the ``torch.profiler.profile``,
    whose events are read after the block. The device's queued work is
    waited for before the trace stops. With ``log_dir`` the trace is
    written there as ``trace-<ns>.json`` (Chrome's format; ``top_ops``
    reads the newest). On ``cuda`` a trace that holds no device activity
    raises: a trace without the device's lane would hide the device."""
    device = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, profile_memory=profile_memory) as prof:
        yield prof
        synchronize(device)
    if log_dir is None:
        events = _profile_events(prof)
    else:
        out = Path(log_dir) / f"trace-{time.time_ns()}.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
        logger.info("trace written to %s", out)
        events = _trace_events(out)
    if device.type == "cuda" and not any(e.on_device for e in events):
        raise RuntimeError("the profiler recorded no CUDA activity")


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def sync(value) -> None:
    """Wait for the devices of every tensor in ``value`` (nested dicts,
    lists and tuples)."""
    for dev in {t.device for t in _tensors(value)}:
        synchronize(dev)


@contextlib.contextmanager
def measure_time(name: str = "block", sync_value=None):
    """Synchronized wall-clock timer: yields a dict; on exit the devices of
    its ``value`` (else of ``sync_value``) are waited for and ``elapsed``
    (seconds) is set."""
    t0 = time.time()
    holder = {}
    try:
        yield holder
    finally:
        value = holder.get("value", sync_value)
        if value is not None:
            sync(value)
        elapsed = time.time() - t0
        holder["elapsed"] = elapsed
        logger.info("%s took %.4fs", name, elapsed)


def timeit(fn, *args, reps: int = 10, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``warmup`` calls, then ``reps``
    calls each waited for on its outputs' devices."""
    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.time()
    for _ in range(reps):
        sync(fn(*args))
    return (time.time() - t0) / reps


def elapsed_ms(fn, device) -> float:
    """ms of one call of ``fn``: between CUDA events recorded around it on
    a CUDA device (the device's time, or the host's where it queues work
    slower than the device runs it), by the host's clock after a
    synchronize on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


# ------------------------------------------------------------------ reading
class _Event(NamedTuple):
    name: str
    thread: object
    start: float  # us
    end: float  # us
    on_device: bool


def _on_device(e) -> bool:
    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def _profile_events(prof):
    return [_Event(e.name, e.thread, e.time_range.start, e.time_range.end, _on_device(e))
            for e in prof.events() if e.time_range.end >= e.time_range.start]


def newest_trace(trace_dir):
    """The newest ``trace-*.json`` under ``trace_dir`` (any depth), or None."""
    traces = list(Path(trace_dir).rglob(TRACE_GLOB))
    return max(traces, key=lambda p: (p.stat().st_mtime_ns, p.name)) if traces else None


def _trace_events(path):
    stat = Path(path).stat()
    return _read_trace(str(path), stat.st_mtime_ns, stat.st_size)


@functools.lru_cache(maxsize=2)
def _read_trace(path: str, mtime_ns: int, size: int):
    """A trace file's complete events (kept for the next reader of the
    same file, unchanged)."""
    events = []
    for ev in json.loads(Path(path).read_text()).get("traceEvents", []):
        if (ev.get("ph") != "X" or ev.get("cat") == "gpu_user_annotation"
                or ev["name"].startswith(PROFILER_SPAN)):
            continue
        start = float(ev["ts"])
        events.append(_Event(ev["name"], (ev.get("pid"), ev.get("tid")), start,
                             start + float(ev.get("dur", 0.0)),
                             ev.get("cat") in DEVICE_CATEGORIES))
    return tuple(events)


def _events(source):
    if isinstance(source, (str, Path)):
        path = Path(source)
        if path.is_dir():
            path = newest_trace(path)
            if path is None:
                return None
        return _trace_events(path)
    return _profile_events(source)


def _self_times(events):
    """Each event's duration less the durations of the events directly
    nested in it on its thread, in the events' order."""
    order = sorted(range(len(events)),
                   key=lambda i: (str(events[i].thread), events[i].start, -events[i].end))
    self_time = [e.end - e.start for e in events]
    stack = []
    for i in order:
        e = events[i]
        while stack and (events[stack[-1]].thread != e.thread
                         or events[stack[-1]].end <= e.start):
            stack.pop()
        if stack:
            self_time[stack[-1]] -= e.end - e.start
        stack.append(i)
    return self_time


def op_totals(source, device="cuda"):
    """(ms by name, calls by name) ``Counter``s of the lane ``device``
    names, from a live profile, a trace file, or the newest trace under a
    directory (None where the directory holds none)."""
    events = _events(source)
    if events is None:
        return None
    on_device = torch.device(device).type == "cuda"
    lane = [e for e in events if e.on_device == on_device]
    times = ([e.end - e.start for e in lane] if on_device else _self_times(lane))
    durations, counts = collections.Counter(), collections.Counter()
    for e, us in zip(lane, times):
        durations[e.name] += us / 1e3
        counts[e.name] += 1
    return durations, counts


def top_ops(trace_dir_or_profile, k: int = 25, device="cuda"):
    """Print the ``k`` ops of the lane ``device`` names that took the most
    time, with their share and calls, in the JAX package's format, and
    return the ms ``Counter`` by name (None, with a message on stderr,
    where a directory holds no trace)."""
    totals = op_totals(trace_dir_or_profile, device)
    if totals is None:
        print("no trace found", file=sys.stderr)
        return None
    durations, counts = totals
    plane = "/device:cuda" if torch.device(device).type == "cuda" else "/host:cpu"
    total = sum(durations.values())
    print(f"\n== plane: {plane} (total {total:.2f} ms) ==")
    for name, dur in durations.most_common(k):
        print(f"{dur:9.3f} ms  {100 * dur / max(total, 1e-9):5.1f}%  "
              f"x{counts[name]:<5d} {name[:90]}")
    return durations


def device_ms(prof) -> float:
    """ms of device work in a live profile: the summed self device time of
    its events (copies included)."""
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def device_busy(source) -> dict:
    """The window of a trace (its first event's start to its last event's
    end) and the time in it during which the device ran work (kernels,
    copies and sets, overlaps counted once): ``busy_ms``, ``window_ms``,
    ``busy_share`` and ``idle_share``."""
    events = [e for e in _events(source) if e.end > e.start]
    start = min(e.start for e in events)
    end = max(e.end for e in events)
    busy, reach = 0.0, start
    for lo, hi in sorted((e.start, e.end) for e in events if e.on_device):
        if hi > reach:
            busy += hi - max(lo, reach)
            reach = hi
    share = busy / (end - start)
    return {"busy_ms": busy / 1e3, "window_ms": (end - start) / 1e3,
            "busy_share": share, "idle_share": 1.0 - share}


def table(prof, sort_by: str = "self_device_time_total", row_limit: int = 15) -> str:
    """A live profile's ops by name as torch.profiler's table."""
    return prof.key_averages().table(sort_by=sort_by, row_limit=row_limit)
