"""The benchmark's files against its contract, on the CPU: no import of
the JAX package, names and units, every piece found by name, and a new
cell added as files and entries alone."""

from __future__ import annotations

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from port_bench import flows, harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def py_files(top=BENCH):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(py_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_import(path):
    tops = set(imported_tops(path))
    assert not tops & set(harness.FORBIDDEN), tops
    if os.sep + "reference" + os.sep in path:
        assert "nle_tpu_torch" not in tops and "port_bench" not in tops


def test_guard_names_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "nle_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxlibrary", object())
    assert "nle_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nle_tpu.ops", object())
    assert harness.forbidden_modules() == ["nle_tpu"]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # The check's time: 2 + 14 runs a cell at 24 cells fits 43200 s.
    assert ((2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200
            <= 43200)
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert c["file"].startswith("port_bench/")
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert w["config"] in names
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    everything = ([m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
                  + [w["name"] for w in SPEC["workloads"]] + names)
    assert len(everything) == len(set(everything))


def test_every_piece_found_by_name():
    bench = harness.Benchmark()
    for w in SPEC["workloads"]:
        cell = bench.cell(w["name"])
        config = bench.config(cell)
        traffic = bench.traffic(cell)
        limits = bench.limits(cell)
        assert len(config["shape"]) == 2
        assert issubclass(flows.load(traffic["flow"]), flows.Flow)
        assert limits["limits"] and set(limits["limits"]) <= {
            "eig_gap", "px_mismatch", "px_max"}
        per_layer = bench.per_layer(w["name"])
        assert per_layer
        for m in per_layer:
            mod = harness.load_metric(m["name"])
            assert (mod.LAYER in m["layer"], mod.UNIT, mod.MOVES) == (
                True, m["unit"], m["moves"].split(".")[0])
            assert m["moves"] in {e["name"] for e in bench.end_to_end(
                w["name"])}
            assert w["name"] in m["workloads"]
    for m in SPEC["per_layer"]:
        quantity = m["name"].split(".")[0]
        if quantity.endswith("_roofline"):
            assert m["unit"] == "%"
            from port_bench.roofline import load_work

            assert load_work(quantity[:-len("_roofline")]).KERNELS


def test_new_cell_needs_no_edit(tmp_path):
    """A cell added as a flow file (its own loop, log line and end-to-end
    value), a traffic file, a limits file, a metric file and entries in
    BENCHMARK.json runs with no other file touched."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "tiny-new", "config": "photo8mp",
                              "traffic": "tiny_new", "chips": 1,
                              "why": "a cell added by files alone"})
    for name, unit in (("mps.tiny", "MP/s"), ("frame_s.tiny", "s")):
        spec["end_to_end"].append({"name": name, "unit": unit,
                                   "better": "higher", "bound": 0.25,
                                   "source": "host_clock",
                                   "workloads": ["tiny-new"]})
    spec["per_layer"].append({"name": "frames_ms", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "window", "moves": "mps.tiny",
                              "workloads": ["tiny-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.loads((root / "port_bench/traffic/taj_denoise.json")
                         .read_text())
    traffic["recipe"] = [4, 4, 200.0, 30.0, 10, 6]
    traffic["flow"] = "tiny_flow"
    (root / "port_bench/flows/tiny_flow.py").write_text(
        "from port_bench.flows.denoise import Denoise\n\n\n"
        "class Tiny(Denoise):\n"
        "    def report(self, outcome, say):\n"
        "        say('tiny flow ran')\n\n"
        "    def end_to_end(self, outcome, seconds, n_pixels, peak):\n"
        "        v = super().end_to_end(outcome, seconds, n_pixels, peak)\n"
        "        v['frame_s'] = (seconds / len(outcome.outputs), 's')\n"
        "        return v\n\n\n"
        "FLOW = Tiny\n")
    (root / "port_bench/traffic/tiny_new.json").write_text(
        json.dumps(traffic))
    (root / "port_bench/cells/tiny-new.json").write_text(json.dumps(
        {"limits": {"eig_gap": 1e-3, "px_mismatch": 0.05, "px_max": 8}}))
    (root / "port_bench/metrics/frames_ms.py").write_text(
        "LAYER = 'window'\nUNIT = 'ms'\nMOVES = 'mps'\n\n\n"
        "def read(trace):\n    return trace.window_s * 1e3 / trace.frames\n")
    script = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(root)!r}, {ROOT!r}]\n"
        "from port_bench import harness\n"
        "assert harness.HERE.startswith(sys.path[0])\n"
        "b = harness.Benchmark()\n"
        "kw = dict(config={'shape': [40, 48], 'filter': {}})\n"
        "for trace in (False, True):\n"
        "    r = harness.run_cell(b, 'tiny-new', 5, 0.2, trace, 'cpu',\n"
        "                         time.perf_counter(), **kw)\n"
        "    print(json.dumps(r))\n")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr[-3000:]
    untraced, traced = [json.loads(x) for x in res.stdout.splitlines()
                        if x.startswith("{")]
    assert "tiny flow ran" in res.stdout
    assert untraced["correct"] is True and traced["correct"] is True
    assert set(untraced["metrics"]) == {"mps.tiny", "frame_s.tiny",
                                        "peak_b_per_px", "setup_s"}
    assert set(traced["metrics"]) == {"frames_ms"}
