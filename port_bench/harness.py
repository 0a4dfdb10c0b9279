"""The benchmark of nle_tpu_torch, driven by BENCHMARK.json.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell names a configuration (`configs/<name>.json`: the frame shape and
the NLEFilter options) and a traffic mix (`traffic/<name>.json`: the flow,
the recipe and the frames' parameters); the traffic's flow, the loop that
drives the program, is `flows/<flow>.py`; `cells/<name>.json` holds the
limits of its check; each per-layer metric is `metrics/<name>.py` and each
roofline's work `work/<name>.py`. All are found by name.

A run, one process: set-up (imports, CUDA, the kernel library, the seeded
frame pool, warm-up frames at the cell's own shape and recipe), timed as
setup_s; the window, a closed loop of whole frames for `--seconds`, with
the frames already started let finish; the check of a sample of the
window's frames against the plain reference (`reference/nle.py`); the
guard that the JAX package was never loaded; one JSON line last.
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "nle_tpu")
# Finished frames of a run that the check compares with the reference.
CHECK_FRAMES = 1


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


class Benchmark:
    """BENCHMARK.json and the files it names, found by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.spec = load_json(root, "BENCHMARK.json")
        self.bench_dir = os.path.join(root, "port_bench")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return load_json(self.root, c["file"])
        raise KeyError(f"no config {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return load_json(self.bench_dir, "traffic", f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return load_json(self.bench_dir, "cells", f"{cell['name']}.json")

    def _applies(self, metric: dict, cell: str, e2e: set) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list[dict]:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if self._applies(m, cell, e2e)]


def load_metric(name: str):
    """The reader metrics/<name>.py; a quantity split by cells,
    `<quantity>.<group>`, shares the reader metrics/<quantity>.py."""
    import importlib.util

    path = os.path.join(HERE, "metrics", f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(HERE, "metrics", f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class CarrierRecords(logging.Handler):
    """The int16 carrier guard's records (nle_tpu_torch.carrier): one
    (crush, retrained) per dense train that engaged the carrier."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen: list[tuple[float, bool]] = []

    def emit(self, record):
        if hasattr(record, "crush"):
            self.seen.append((float(record.crush), bool(record.retrained)))

    def __enter__(self):
        log = logging.getLogger("nle_tpu_torch.carrier")
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger("nle_tpu_torch.carrier")
        log.removeHandler(self)
        log.setLevel(self._level)


def compare(out: np.ndarray, S: np.ndarray, ref_out: np.ndarray,
            ref_S: np.ndarray) -> dict:
    """The numbers the check holds to its limits, for one frame:
    eig_gap, the widest gap of an eigenvalue from the reference's over the
    reference's largest (the shorter list padded with zeros, as the
    program pads the eigenvalues below eps); px_mismatch, the share of
    output bytes that differ; px_max, the widest byte difference."""
    n = max(S.size, ref_S.size)
    gap = np.abs(np.pad(S, (0, n - S.size))
                 - np.pad(ref_S, (0, n - ref_S.size)))
    eig_gap = float(gap.max() / abs(ref_S[0]))
    if out.shape != ref_out.shape:
        return {"eig_gap": eig_gap, "px_mismatch": 1.0, "px_max": 255.0}
    diff = np.abs(out.astype(np.int16) - ref_out.astype(np.int16))
    return {"eig_gap": eig_gap, "px_mismatch": float(np.mean(diff > 0)),
            "px_max": float(diff.max())}


def check_sample(seed: int, done: list[int], count: int) -> list[int]:
    """`count` frame indices of the finished ones, drawn from the seed."""
    from port_bench.frames import seed_words

    rng = np.random.default_rng([seed_words(seed), 0xC4EC])
    k = min(count, len(done))
    return sorted(int(i) for i in rng.choice(done, size=k, replace=False))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX package's or JAX's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ") or "not read"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def route_of(launches: dict) -> str:
    """A frame's route from its kernel launch counts."""
    parts = ["dense" if launches.get("affinity_matmul") else "no kernel"]
    if launches.get("sinkhorn_halfstep_f32"):
        parts.append("f32 carrier")
    return "+".join(parts)


class WarmSource:
    """The warm-up frames: pool frames unshifted, which the window never
    uses (its offsets are nonzero)."""

    def __init__(self, source):
        self.source = source

    def frame(self, i: int) -> np.ndarray:
        return self.source.pool[i % len(self.source.pool)]


def frame_seconds(outcome) -> str:
    """Quartiles of the frames' host wall times, for the log."""
    secs = sorted(e - s for s, e in outcome.times.values())
    if not secs:
        return "none timed"
    qs = np.quantile(secs, [0.0, 0.25, 0.5, 0.75, 1.0])
    return "min {:.3f}, q1 {:.3f}, median {:.3f}, q3 {:.3f}, max {:.3f} s" \
        .format(*qs)


def run_cell(bench: Benchmark, cell_name: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, out=sys.stdout):
    """One run of a cell; returns the result dict (the last line)."""
    import torch

    from port_bench import flows
    from port_bench.frames import FrameSource
    from port_bench.trace import WINDOW, Trace

    cell = bench.cell(cell_name)
    config = config or bench.config(cell)
    traffic = traffic or bench.traffic(cell)
    limits = limits or bench.limits(cell)
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def say(msg):
        print(msg, file=out, flush=True)

    from nle_tpu_torch.ops.kernels import _build

    if cuda:
        _build.load()
        say(f"kernels: library {os.path.basename(_build.library_path())}, "
            f"nvcc {_build.build_seconds} s (None: built before)")
    shape = tuple(config["shape"])
    n_pixels = shape[0] * shape[1]
    source = FrameSource(shape, float(traffic.get("noise_sigma", 0.0)), seed,
                         dev)
    flow_cls = flows.load(traffic["flow"])
    flow = flow_cls(config, traffic, dev)
    n_warm = int(traffic["warmup_frames"])
    with CarrierRecords() as warm_rec:
        warm = flow.run(WarmSource(source), lambda i: i < n_warm)
    if warm.errors:
        raise RuntimeError(f"warm-up failed: {warm.errors}")
    del warm
    gc.collect()
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    setup_s = time.perf_counter() - t_start

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    with CarrierRecords() as rec:
        with torch.profiler.record_function(WINDOW):
            t0 = time.perf_counter()
            outcome = flow.run(source, flows.closed_loop(t0 + seconds))
            if cuda:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = dict(_build.LAUNCHES)

    done = sorted(outcome.outputs)
    attempted = outcome.started
    failed = attempted - len(done)
    eig = {i: outcome.eig_host(i) for i in done}
    say(f"card: {card_line() if cuda else 'none (cpu run)'}; "
        f"devices {torch.cuda.device_count() if cuda else 0}")
    say(f"frames: {attempted} started, {len(done)} done, {failed} failed "
        f"in {t1 - t0:.3f} s ({shape[1]}x{shape[0]}, {n_pixels} px); "
        f"warm-up frames {n_warm}; setup {setup_s:.3f} s")
    say(f"frame seconds: {frame_seconds(outcome)}")
    for i, err in sorted(outcome.errors.items()):
        say(f"frame {i} failed: {err}")
    say("launches in the window: " + json.dumps(
        {k: v for k, v in launches.items() if v}))
    say("routes: " + ", ".join(route_of(r) for r in outcome.routes))
    crushes = [c for c, _ in rec.seen]
    say(f"carrier guard: {sum(r for _, r in rec.seen)} trips of "
        f"{len(rec.seen)} carrier trains in the window (warm-up "
        f"{sum(r for _, r in warm_rec.seen)} of {len(warm_rec.seen)}); "
        f"largest crush {max(crushes) if crushes else None}")
    say(f"peak: setup {setup_peak} B, window {window_peak} B")
    flow.report(outcome, say)

    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": {
                  "platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(max(setup_peak, window_peak))}}
    if not trace:
        values = flow.end_to_end(outcome, t1 - t0, n_pixels, window_peak)
        values["setup_s"] = (setup_s, "s")
        for m in bench.end_to_end(cell_name):
            v, unit = values[m["name"].split(".")[0]]
            result["metrics"][m["name"]] = {"value": v, "unit": unit}
    else:
        tr = Trace.from_profiler(prof, len(done),
                                 flow.work_frames(source, done))
        for m in bench.per_layer(cell_name):
            v = load_metric(m["name"]).read(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        del tr, prof

    # The program's state goes before the reference runs.
    outputs = outcome.outputs
    del outcome, flow
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    worst = {}
    checked = check_sample(seed, done, CHECK_FRAMES)
    ref = flow_cls(config, traffic, dev)
    for i in checked:
        ref_out, ref_S = ref.reference(source.frame(i), dev)
        got = compare(outputs[i], eig[i], ref_out,
                      np.asarray(ref_S, np.float64))
        for name, v in got.items():
            worst[name] = max(worst.get(name, 0.0), v)
    say(f"check: frames {checked} against the reference in "
        f"{time.perf_counter() - t_ref:.3f} s; readings {json.dumps(worst)}")
    numbers = {name: {"value": worst.get(name), "limit": lim}
               for name, lim in limits["limits"].items()}
    result["correct"] = bool(
        checked and failed == 0
        and all(v["value"] is not None and v["value"] <= v["limit"]
                for v in numbers.values()))
    result["check"] = numbers
    return result


def finish(result: dict, out=sys.stdout) -> int:
    """The guard, the check's numbers on standard error, the last line."""
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures "
              "nle_tpu_torch alone", file=sys.stderr)
        return 3
    for name, v in result["check"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    check = result.pop("check")
    result["check"] = check          # the last key of the line
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Benchmark()
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: the benchmark runs on an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"{torch.cuda.device_count()} cards; the cell asks for "
              f"{cell['chips']}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    return finish(result)
