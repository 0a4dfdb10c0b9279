"""CPU readings behind two PERF.md/ROADMAP.md entries of the PyTorch port
(a script, not a test: pytest does not collect it).

    JAX_PLATFORMS=cpu python tests/torch_cpu_readings.py device-route
    JAX_PLATFORMS=cpu python tests/torch_cpu_readings.py fragility [runs]
    JAX_PLATFORMS=cpu python tests/torch_cpu_readings.py fragility-nle-tpu [runs]

device-route: stage1="device" (Ka's eigh in float32) against the default
host64 route, in nle_tpu and in the port, on chip_smoke's structured frame
at 208x304 and 416x608 with the rock2 parameters (PSNR of the enhanced
images), and the two packages' device routes against each other.

fragility: NLEFilter(device="cpu").train_for_enhancement of the 208x304
frame in `runs` fresh processes (four at a time, OMP_NUM_THREADS=2), with
and without MKL_CBWR=COMPATIBLE: how many give a filter eigenvalue above
1.01 (a broken train; the largest is ~0.998 otherwise). Since the plain
versions on the route sum in float64 (tests/test_torch_cpu_sum_order.py)
every train gives the same largest eigenvalue, with or without
MKL_CBWR=COMPATIBLE. fragility-nle-tpu: the same train by nle_tpu's
NLEFilter on the CPU (XLA's dot, no MKL), without MKL_CBWR.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((208, 304), (416, 608))


def device_route() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke as cs
    from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
    from nle_tpu_torch import NLEFilter

    for shape in SHAPES:
        img = cs.structured_frame(*shape)
        args, w = cs.MAIN_ARGS, cs.WEIGHTS
        jd = JaxNLEFilter().train_and_enhance(img, *args, weights=w)
        jv = JaxNLEFilter(stage1="device").train_and_enhance(img, *args,
                                                             weights=w)
        td = NLEFilter(device="cpu").train_and_enhance(img, *args, weights=w)
        tv = NLEFilter(device="cpu", stage1="device").train_and_enhance(
            img, *args, weights=w)
        print(f"{shape[0]}x{shape[1]}: nle_tpu device vs default "
              f"{cs.psnr(jv, jd):.2f} dB; port device vs default "
              f"{cs.psnr(tv, td):.2f} dB; port vs nle_tpu, device "
              f"{cs.psnr(tv, jv):.2f} dB, default {cs.psnr(td, jd):.2f} dB",
              flush=True)


ONE_TRAIN = (
    "import sys; sys.path.insert(0, {root!r}); import chip_smoke as cs; "
    "from nle_tpu_torch import NLEFilter; "
    "t = NLEFilter(device='cpu').train_for_enhancement("
    "cs.structured_frame(208, 304), *cs.MAIN_ARGS); "
    "print(float(t.eigvals.max()))")


ONE_TRAIN_NLE_TPU = (
    "import sys; sys.path.insert(0, {root!r}); import jax; "
    "jax.config.update('jax_platforms', 'cpu'); import chip_smoke as cs; "
    "from nle_tpu.models.filter import NLEFilter; "
    "t = NLEFilter().train_for_enhancement("
    "cs.structured_frame(208, 304), *cs.MAIN_ARGS); "
    "print(float(t.eigvals.max()))")


def fragility(runs: int, nle_tpu: bool = False) -> None:
    code = (ONE_TRAIN_NLE_TPU if nle_tpu else ONE_TRAIN).format(root=ROOT)
    for cbwr in (None,) if nle_tpu else (None, "COMPATIBLE"):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        if cbwr:
            env["MKL_CBWR"] = cbwr
        tops = []
        for lo in range(0, runs, 4):
            procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.DEVNULL, text=True)
                     for _ in range(min(4, runs - lo))]
            tops += [float(p.communicate()[0].split()[-1]) for p in procs]
        bad = [t for t in tops if t > 1.01]
        print(f"MKL_CBWR={cbwr}: {len(bad)} of {len(tops)} trains broken "
              f"(largest eigenvalue {max(tops):.6g}; good ones "
              f"{min(tops):.6g}; {len(set(tops))} distinct values)",
              flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "device-route"
    if what == "device-route":
        device_route()
    elif what in ("fragility", "fragility-nle-tpu"):
        fragility(int(sys.argv[2]) if len(sys.argv) > 2 else 16,
                  nle_tpu=what == "fragility-nle-tpu")
    else:
        sys.exit(f"unknown reading {what!r}: device-route | fragility | "
                 "fragility-nle-tpu")
