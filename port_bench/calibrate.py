"""Readings behind the check's limits, on the card, in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds N [N ...]
        [--control] [--program]

For each seed, the frame a run of that seed would check first (drawn as
harness.check_sample draws it, from eight finished frames) is run
through the plain reference in float64, and compared as a run compares
(harness.compare) with:
- --control: the same reference in bfloat16 (reference/nle.py's
  `precision`), the control, which a sound limit has to fail;
- --program: the cell's own flow on that one frame (the program's
  reading; the runs' own readings are the lower reading's main source).
One JSON line a seed and side. Not run by the benchmark's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from port_bench import flows, harness  # noqa: E402
from port_bench.frames import FrameSource  # noqa: E402


class OneFrame:
    def __init__(self, frame):
        self.frame_ = frame

    def frame(self, i):
        return self.frame_


def readings(bench, cell_name: str, seeds, control: bool, program: bool,
             device: str = "cuda", config=None, traffic=None, out=sys.stdout):
    cell = bench.cell(cell_name)
    config = config or bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    dev = torch.device(device)
    flow = flows.load(traffic["flow"])(config, traffic, dev)
    rows = []
    for seed in seeds:
        source = FrameSource(tuple(config["shape"]),
                             float(traffic.get("noise_sigma", 0.0)), seed, dev)
        (i,) = harness.check_sample(seed, list(range(8)), 1)
        frame = source.frame(i)
        t = time.perf_counter()
        ref_out, ref_S = flow.reference(frame, dev)
        ref_s = time.perf_counter() - t
        sides = []
        if control:
            t = time.perf_counter()
            c_out, c_S = flow.reference(frame, dev, precision=torch.bfloat16)
            sides.append(("control", c_out, np.asarray(c_S, np.float64),
                          time.perf_counter() - t))
        if program:
            t = time.perf_counter()
            o = flow.run(OneFrame(frame), lambda j: j == 0)
            if o.errors:
                raise RuntimeError(o.errors)
            sides.append(("program", o.outputs[0], o.eig_host(0),
                          time.perf_counter() - t))
        for side, o_out, o_S, secs in sides:
            row = {"workload": cell_name, "seed": seed, "frame": i,
                   "side": side, "seconds": secs, "ref_seconds": ref_s,
                   **harness.compare(o_out, o_S, ref_out,
                                     np.asarray(ref_S, np.float64))}
            rows.append(row)
            print(json.dumps(row), file=out, flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    from nle_tpu_torch.ops.kernels import _build

    _build.load()
    readings(harness.Benchmark(), args.workload, args.seeds, args.control,
             args.program)
    return 0


if __name__ == "__main__":
    sys.exit(main())
