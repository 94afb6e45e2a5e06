"""The traced run's reading of torch.profiler.

The profiler runs over a few periods inside the window (CPU and CUDA
activities, no shapes, no stacks) and nothing is written to disk: the
events are reduced here to a summary, which the per-layer readers
(`benchmark/metrics/`) take their numbers from.

- device busy: the union of the device's kernel, copy and fill
  intervals; the traced window is the host's clock over the traced
  periods;
- host operations: aten operations dispatched from Python, each counted
  once (an aten operation inside another is not counted);
- syncs: the host's waits on the device (stream, device and event
  synchronizations), less the harness's own one a period;
- kernels: device time and launches by name;
- idle gaps: the device's idle intervals by what the host was doing at
  their middle (the outermost aten operation, else the CUDA runtime
  call, else "python").
"""

from __future__ import annotations

import bisect

import torch

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
TOP = 10


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _outermost_aten(e) -> bool:
    if not e.name.startswith("aten::"):
        return False
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


def summarize(prof, periods: int, window_s: float) -> dict:
    """The summary of a profiler that covered `periods` periods lasting
    `window_s` seconds on the host's clock."""
    events = list(prof.events())
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA]
    kernels = {}
    for e in dev:
        t = kernels.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.elapsed_us() * 1e-6
        t[1] += 1
    busy = _merge([(e.time_range.start, e.time_range.end) for e in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    aten = [e for e in host if _outermost_aten(e)]
    syncs = sum(1 for e in host if e.name in SYNC_CALLS)
    # what the host did while the device idled
    label_iv = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in aten)
    runtime_iv = sorted((e.time_range.start, e.time_range.end, e.name)
                        for e in host if e.name.startswith("cuda"))
    starts = [iv[0] for iv in label_iv]
    rstarts = [iv[0] for iv in runtime_iv]

    def doing(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and label_iv[i][1] >= t:
            return label_iv[i][2]
        i = bisect.bisect_right(rstarts, t) - 1
        if i >= 0 and runtime_iv[i][1] >= t:
            return runtime_iv[i][2]
        return "python"

    gaps = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        name = doing(0.5 * (end + nxt))
        gaps[name] = gaps.get(name, 0.0) + (nxt - end) * 1e-6
    by_time = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        periods=periods, window_s=window_s, busy_s=busy_s,
        host_ops=len(aten), syncs=syncs - periods,
        kernels={k: dict(seconds=v[0], launches=v[1])
                 for k, v in kernels.items()},
        device_ops=[[k, v[0]] for k, v in sorted(
            kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        idle_gaps=[[k, v] for k, v in by_time(gaps)])
