"""The traced windows: ``torch.profiler`` over a fixed number of cycles,
its Chrome trace read back into what the per-layer readers take.

A run traces its cycles twice.  The device pass records the CUDA activity
alone (the device's kernels and copies and the host's CUDA runtime
calls): the device's busy time, the span of the cycles and the kernels
come from it, since the profiler's record of every host operation would
stretch the cycles it measures.  The host pass records both activities,
for the spans and for naming the idle gaps by what the host was doing.

The benchmark names its own spans (``torch.profiler.record_function``)
around the calls into each layer from its own files (``program.spans``):
``h100bench.window`` around the traced cycles and their closing device
sync, ``h100bench.stage`` around the stage dispatch point,
``h100bench.fld_matvec`` around the FLD operator's.  A device operation
belongs to a span when the host call that launched it (matched by the
trace's correlation id) lies inside the span.
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# host events that can say what the host was doing during an idle gap
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
WINDOW = "h100bench.window"


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class TraceWindow:
    """What the per-layer readers take from one traced window (seconds).
    The window is the benchmark's ``h100bench.window`` span, or in a trace
    of the CUDA activity alone, which holds no span, from the first host
    runtime call or device operation to the end of the last (the closing
    device sync)."""

    def __init__(self, events, cycles: int):
        self.cycles = cycles
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if win:
            w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        else:
            timed = [e for e in events if e.get("ph") == "X"
                     and e.get("cat") in DEVICE_CATS + LAUNCH_CATS]
            if not timed:
                raise RuntimeError(f"the trace holds no {WINDOW} span and no CUDA event")
            w0 = min(e["ts"] for e in timed)
            w1 = max(e["ts"] + e.get("dur", 0.0) for e in timed)
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and e["ts"] < w1 and e["ts"] + e.get("dur", 0.0) > w0]
        busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev])
        self.busy_s = sum(b - a for a, b in busy) * 1e-6
        self.kernels = sum(1 for e in dev if e["cat"] == "kernel")
        self.device_ops = len(dev)
        by_name = {}
        for e in dev:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        self.top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

        # the benchmark's spans on the host, and each device op's launch
        self.spans = {}
        for e in events:
            if e.get("cat") == "user_annotation" and e.get("name", "").startswith("h100bench."):
                self.spans.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
        launch_ts = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launch_ts[corr] = e["ts"]
        self.matched = 0
        self.span_device_s = {name: 0.0 for name in self.spans}
        starts = {name: sorted(v) for name, v in self.spans.items()}
        for e in dev:
            ts = launch_ts.get(e.get("args", {}).get("correlation"))
            if ts is None:
                continue
            self.matched += 1
            for name, iv in starts.items():
                if name == WINDOW:
                    continue
                k = bisect_right(iv, (ts, float("inf"))) - 1
                if k >= 0 and iv[k][0] <= ts <= iv[k][1]:
                    self.span_device_s[name] += e["dur"] * 1e-6

        # the idle gaps inside the window, each named by the innermost
        # host event running at its midpoint
        gaps = []
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
        host = sorted((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]) for e in events
                      if e.get("ph") == "X" and e.get("cat") in HOST_CATS)
        host_starts = [h[0] for h in host]
        idle = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            name, best = "(no host event)", None
            # the innermost event began shortly before the midpoint: look
            # back over the last few hundred host events only
            k_hi = bisect_right(host_starts, mid)
            for h0, h1, hn in host[max(0, k_hi - 256):k_hi]:
                if h1 >= mid and (best is None or h1 - h0 < best):
                    name, best = hn, h1 - h0
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
        self.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def summary(self) -> str:
        return (f"traced window {self.window_s:.6f} s over {self.cycles} cycles: device busy "
                f"{self.busy_s:.6f} s, {self.kernels} kernels of {self.device_ops} device ops, "
                f"{self.matched} matched to their launch; spans "
                + ", ".join(f"{n} x{len(v)} {self.span_device_s.get(n, 0.0):.6f} s"
                            for n, v in sorted(self.spans.items())))


def traced(run_cycles, cycles: int, device, host: bool = True):
    """Run ``run_cycles()`` under the profiler inside the window span and
    return its TraceWindow: with ``host``, both activities; without it,
    the CUDA activity alone (the device pass).  The Chrome trace goes to a
    file under the temporary directory and is deleted after it is read.
    On the CPU (the tests) only the host is traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"
    acts = (([ProfilerActivity.CPU] if host or not on_card else [])
            + ([ProfilerActivity.CUDA] if on_card else []))
    if on_card:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            run_cycles()
            if on_card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return TraceWindow(events, cycles)
