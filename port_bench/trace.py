"""What a traced window holds, read from torch.profiler's events.

`Trace` keeps four kinds of record, times in microseconds on one clock:
host ranges (the program's `stage()` ranges and the benchmark's own, as
torch.profiler.record_function writes them), device kernels, and device
copies and sets. It is made from a finished profiler (`from_profiler`) or
from a Chrome trace file as the profiler exports it (`from_chrome`, the
tests' small recorded traces). The per-layer metrics
(`metrics/<name>.py`) read it through the helpers below.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

WINDOW = "port_bench.window"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass(frozen=True)
class Record:
    kind: str        # "user_annotation" or one of DEVICE_KINDS
    name: str
    start: float     # us
    dur: float       # us
    tid: int = 0

    @property
    def end(self) -> float:
        return self.start + self.dur


def merged(intervals):
    """The union of (start, end) intervals, as sorted disjoint pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, records, frames: int, work_frames=()):
        self.records = list(records)
        self.frames = frames
        # One roofline.FrameShape per traced frame.
        self.work_frames = list(work_frames)
        wins = [r for r in self.records
                if r.kind == "user_annotation" and r.name == WINDOW]
        if len(wins) != 1:
            raise ValueError(f"{len(wins)} '{WINDOW}' ranges in the trace")
        self.t0, self.t1 = wins[0].start, wins[0].end

    @classmethod
    def from_chrome(cls, path: str, frames: int, work_frames=()):
        """From a Chrome trace file, as torch.profiler exports it."""
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        keep = ("user_annotation",) + DEVICE_KINDS
        recs = [Record(e["cat"], e["name"], float(e["ts"]),
                       float(e.get("dur", 0.0)), int(e.get("tid", 0))
                       if str(e.get("tid", 0)).isdigit() else 0)
                for e in events
                if e.get("ph") == "X" and e.get("cat") in keep]
        return cls(recs, frames, work_frames)

    @classmethod
    def from_profiler(cls, prof, frames: int, work_frames=()):
        """From a finished torch.profiler.profile, through its Chrome
        trace (a temporary file, removed once read)."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            return cls.from_chrome(path, frames, work_frames)
        finally:
            os.unlink(path)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def device(self):
        return [r for r in self.records if r.kind in DEVICE_KINDS
                and r.end > self.t0 and r.start < self.t1]

    def busy_intervals(self):
        return merged((max(r.start, self.t0), min(r.end, self.t1))
                      for r in self.device())

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def ranges(self, *names):
        return [r for r in self.records
                if r.kind == "user_annotation" and r.name in names]

    def range_ms_per_frame(self, *names):
        """Summed duration of the named host ranges over the frames, or
        None where the trace holds none of them."""
        rs = self.ranges(*names)
        if not rs or self.frames <= 0:
            return None
        return sum(r.dur for r in rs) / 1e3 / self.frames

    def kernel_s(self, needles) -> float:
        """Device seconds of the kernels whose names hold any needle."""
        return sum(r.dur for r in self.device() if r.kind == "kernel"
                   and any(n in r.name for n in needles)) / 1e6

    def roofline_pct(self, work_name: str):
        """100 x the work's bound over its kernels' device time, or None
        where none of them ran."""
        from port_bench import roofline

        work = roofline.load_work(work_name)
        t = self.kernel_s(work.KERNELS)
        if t <= 0 or not self.work_frames:
            return None
        return 100.0 * roofline.work_bound_s(work_name, self.work_frames) / t

    def device_ops(self, top: int = 10):
        by = {}
        for r in self.device():
            by[r.name] = by.get(r.name, 0.0) + r.dur / 1e6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """The longest device gaps in the window, each named by the
        innermost host range open at its middle."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for s, e in busy for x in (s, e)] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        host = [r for r in self.records if r.kind == "user_annotation"
                and r.name != WINDOW]
        out = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (s + e) / 2
            open_ = [r for r in host if r.start <= mid < r.end]
            name = (min(open_, key=lambda r: r.dur).name if open_
                    else "no host range")
            out.append([name, (e - s) / 1e6])
        return out
