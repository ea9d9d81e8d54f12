"""Device-timeline busy time: the measure of the union of the intervals in
which the card executed anything, read from torch.profiler's CUDA events.

Counterpart: ogl_tpu/kernels/xplane.py `device_busy_seconds`, which parses
the TPU profiler's xplane.pb.  That parser is not ported: torch.profiler
(CUPTI) records the card's kernels and copies as events directly.  Busy
time is the UNION of the intervals, not their sum: a copy that overlaps a
kernel, or two kernels of two streams, count once, and the host's gaps
between launches do not count at all — the clock that is blind to the host
(ogl_tpu/kernels/roofline.py:262-268).
"""

from __future__ import annotations

import torch

__all__ = ["device_events", "union_seconds", "busy_seconds", "device_busy_seconds"]


def device_events(call):
    """Run `call()` under torch.profiler (CPU and CUDA activities), end in
    torch.cuda.synchronize(); returns (call's result, the CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = call()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, events


def union_seconds(intervals) -> float:
    """Measure of the union of (start, end) intervals given in µs, in s."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total * 1e-6


def busy_seconds(events) -> float:
    """Union busy time of profiler CUDA events (device_events)."""
    return union_seconds((e.time_range.start, e.time_range.end) for e in events)


def device_busy_seconds(call) -> float:
    """Seconds the card was busy while `call()` ran; raises when the
    profiler recorded no device event (the number would not be measured)."""
    _, events = device_events(call)
    if not events:
        raise RuntimeError("torch.profiler recorded no CUDA event: device busy time "
                           "not measured")
    return busy_seconds(events)
