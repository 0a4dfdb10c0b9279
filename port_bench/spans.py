"""Frames and self time of the program's spans in a traced window.

A frame's root span is a public NLEFilter call, `NLEFilter.<method>`
(`nle_tpu_torch/models/filter.py`). Every span that a root encloses on
the same thread belongs to that frame; a root inside another root
(`train_and_enhance` calling `enhance` on the factored path) is part of
the outer one. This serves frames that run one at a time on a thread;
stream mode's overlapping frames would need more.

A span's self time is its duration less the part of its interval that
the spans inside it on its thread cover.
"""

from __future__ import annotations

import bisect

from port_bench.trace import WINDOW, merged

ROOT_PREFIX = "NLEFilter."


def is_root(r) -> bool:
    return r.name.startswith(ROOT_PREFIX)


class Spans:
    """The host spans of a Trace, grouped by thread and sorted by start."""

    def __init__(self, trace):
        by_tid = {}
        for r in trace.records:
            if r.kind == "user_annotation" and r.name != WINDOW:
                by_tid.setdefault(r.tid, []).append(r)
        self.by_tid = {t: sorted(rs, key=lambda r: r.start)
                       for t, rs in by_tid.items()}
        self._starts = {t: [r.start for r in rs]
                        for t, rs in self.by_tid.items()}

    def named(self, *names):
        return [r for rs in self.by_tid.values() for r in rs
                if r.name in names]

    def inside(self, outer):
        """The spans on outer's thread that lie within its interval."""
        rs, starts = self.by_tid[outer.tid], self._starts[outer.tid]
        for i in range(bisect.bisect_left(starts, outer.start), len(rs)):
            r = rs[i]
            if r.start > outer.end:
                break
            if r is not outer and r.end <= outer.end:
                yield r

    def self_us(self, r, count=lambda child: True) -> float:
        """r's duration less the union of the spans inside it for which
        `count` holds."""
        covered = merged((c.start, c.end) for c in self.inside(r)
                         if count(c))
        return r.dur - sum(e - s for s, e in covered)

    def roots(self):
        """The outermost root spans: one a public call, nested ones
        counted with the call that encloses them."""
        rs = [r for rs in self.by_tid.values() for r in rs if is_root(r)]
        inner = {id(c) for r in rs for c in self.inside(r) if is_root(c)}
        return [r for r in rs if id(r) not in inner]


def self_ms_per_frame(trace, *names):
    """Self time of the named spans summed over the window over its
    frames, or None where the trace holds none of them."""
    sp = Spans(trace)
    rs = sp.named(*names)
    if not rs or trace.frames <= 0:
        return None
    return sum(sp.self_us(r) for r in rs) / 1e3 / trace.frames


def model_self_ms_per_frame(trace):
    """The outermost root spans' time that no span but a root covers,
    over the window over its frames, or None where there is no root."""
    sp = Spans(trace)
    rs = sp.roots()
    if not rs or trace.frames <= 0:
        return None
    own = sum(sp.self_us(r, lambda c: not is_root(c)) for r in rs)
    return own / 1e3 / trace.frames
