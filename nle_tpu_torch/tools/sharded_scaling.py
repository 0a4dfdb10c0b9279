"""The pixel-sharded trainers as worker processes, one a rank, and their
scaling over the cards of one host.

    python3 -m nle_tpu_torch.tools.sharded_scaling

On every card of this host, one rank a card over NCCL: the 1 MP dense
main path (an 832x1216 structured frame, rock2 20 30 500 10 50 50) at
(data, pixel) = (1, n) and, with an even n, two jittered copies at
(2, n / 2), and the 32 MP factored path (5656x5656, 24 25 5000 30 50 50)
at (1, n), each run three times (the first a cold run); the same frames
trained on card 0 alone (warm) beside them. Prints each rank's walls,
peak device bytes and launches, the PSNR of each sharded edit against the
single card's and whether the repeats are bitwise equal, then one JSON
line. Exit code 2 without a card.

`run` launches one mesh's ranks (`worker`, `python -m
nle_tpu_torch.tools.sharded_scaling --worker SPEC`) and collects what each
rank wrote; chip_smoke.py [15] drives its gloo meshes sharing one card
through it.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

DENSE_ARGS = (20, 30, 500.0, 10.0, 50, 50)
CAP_ARGS = (24, 25, 5000.0, 30.0, 50, 50)
WEIGHTS = [4, 3, 4, 1]
DENSE_SHAPE = (832, 1216)
CAP_SHAPE = (5656, 5656)
TIMEOUT_S = 300     # seconds a mesh's launch may take


def worker(spec_json: str) -> int:
    """One rank: joins the process group on the spec's device, runs its
    jobs on its mesh and writes DIR/<job tag>_rank<r>.npz: per repeat the
    launch counts, the wall of a train+apply (dense) or of the apply after
    the train's own seconds (factored), the edited L planes (u8), and the
    job's peak device bytes. The kernel library is loaded, not built: the
    caller builds it first."""
    import torch

    import nle_tpu_torch  # noqa: F401  (pins fp32 precision)
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.transform import transform_eigenvalues
    from nle_tpu_torch.parallel import sharded
    from nle_tpu_torch.parallel.distributed import initialize, shutdown

    spec = json.loads(spec_json)
    dev = initialize(spec["init"], spec["world"], spec["rank"],
                     device=spec["device"], backend=spec["backend"],
                     timeout_s=TIMEOUT_S)
    cuda = dev.type == "cuda"
    if cuda:
        _build.load()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def u8(t):
        return torch.clamp(torch.round(t), 0, 255).to(torch.uint8).cpu(
            ).numpy()

    try:
        mesh = sharded.make_mesh(*spec["mesh"])
        for job in spec["jobs"]:
            frames = np.load(job["frames"])
            args = tuple(job["args"])
            out = {}
            sync()
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if cuda else 0
            counts, walls, extra = [], [], []
            for rep in range(job["reps"]):
                _build.reset_launches()
                t0 = time.perf_counter()
                if job["kind"] == "dense":
                    V, S = sharded.train_filter_sharded(
                        frames.astype(np.float32), *args, mesh)
                    edits = [u8(sharded.apply_filter_sharded(
                        V[i], transform_eigenvalues(S[i], WEIGHTS),
                        torch.from_numpy(frames[i]).to(dev), mesh))
                        for i in range(frames.shape[0])]
                    sync()
                    walls.append(time.perf_counter() - t0)
                    # The crush statistic of each frame this rank's row
                    # trained, then whether the guard retrained one.
                    info = mesh.run_info
                    extra.append([info["crush"][i] for i in sorted(
                        info.get("crush", {}))] + [float(any(info.get(
                            "retrained", {}).values()))])
                    del V, S
                else:
                    flts = sharded.train_filter_sharded(
                        frames[None].astype(np.float32), *args, mesh,
                        streaming=True, factored=True)
                    sync()
                    extra.append([time.perf_counter() - t0])
                    t0 = time.perf_counter()
                    fS = transform_eigenvalues(flts[0].eigvals, WEIGHTS)
                    filt = sharded.apply_filter_factored_sharded(
                        flts[0], frames, fS, mesh)
                    edits = [np.clip(np.rint(filt), 0, 255).astype(np.uint8)]
                    walls.append(time.perf_counter() - t0)
                    del flts
                counts.append(dict(_build.LAUNCHES))
                out[f"edit{rep}"] = np.stack(edits)
            out["peak"] = (torch.cuda.max_memory_allocated() - base if cuda
                           else 0)
            out["counts"] = json.dumps(counts)
            out["walls"] = np.array(walls)
            out["extra"] = np.array(extra)
            np.savez(os.path.join(spec["dir"],
                                  f"{job['tag']}_rank{mesh.rank}.npz"), **out)
            if cuda:
                torch.cuda.empty_cache()
    finally:
        shutdown()
    return 0


def run(tmp: str, tag: str, mesh, backend: str, jobs, device="cuda",
        threads: int | None = None) -> dict:
    """Launch one mesh's ranks on `jobs` (dicts: tag, kind "dense" or
    "factored", frames (a .npy path: (B, H, W) L planes, or one (H, W)),
    args, reps) and return {job tag: [each rank's {"counts": [a repeat],
    "walls", "extra", "peak", "edits": [a repeat]}]}. Every rank is
    killed when one fails or TIMEOUT_S passes."""
    from nle_tpu_torch.parallel.distributed import (
        file_init,
        launch,
        worker_env,
    )

    world = mesh[0] * mesh[1]
    init_dir = os.path.join(tmp, f"{tag}_init")
    os.makedirs(init_dir)
    jobs = [dict(j, tag=f"{tag}_{j['tag']}", args=list(j["args"]))
            for j in jobs]
    cmds = [[sys.executable, "-m", "nle_tpu_torch.tools.sharded_scaling",
             "--worker", json.dumps(dict(
                 init=file_init(init_dir), world=world, rank=r,
                 device=device, backend=backend, mesh=list(mesh), dir=tmp,
                 jobs=jobs))]
            for r in range(world)]
    launch(cmds, timeout=TIMEOUT_S, env=worker_env(threads))
    res = {}
    for j in jobs:
        ranks = []
        for r in range(world):
            with np.load(os.path.join(tmp, f"{j['tag']}_rank{r}.npz")) as z:
                ranks.append(dict(
                    counts=json.loads(str(z["counts"])), walls=z["walls"],
                    extra=z["extra"], peak=int(z["peak"]),
                    edits=[z[f"edit{k}"] for k in range(j["reps"])]))
        res[j["tag"][len(tag) + 1:]] = ranks
    return res


def _psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


def scaling() -> dict:
    """The measurement of the module docstring; returns its JSON record."""
    import torch

    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.tools.check_serving import frames, structured_frame

    n = torch.cuda.device_count()
    _build.load()

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    img = structured_frame(*DENSE_SHAPE)
    imgs = [img] + frames(img, 4)[2:4]
    labs = [bgr_to_lab_u8_np(x) for x in imgs]
    single, single_s = {}, []
    for i, x in enumerate(imgs):
        single[i], wall = timed(lambda: NLEFilter(
            device="cuda").train_and_enhance(x, *DENSE_ARGS, weights=WEIGHTS))
        single_s.append(wall)
        print(f"one card, 1 MP frame {i}: {wall:.3f} s warm", flush=True)
    big = structured_frame(*CAP_SHAPE, seed=7)
    lab_big = bgr_to_lab_u8_np(big)
    f = NLEFilter(device="cuda", factored=True)
    f.train_and_enhance(big, *CAP_ARGS, weights=WEIGHTS)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _, train_s = timed(lambda: f.train_for_enhancement(big, *CAP_ARGS))
    cap, apply_s = timed(lambda: f.enhance(big, WEIGHTS))
    peak = torch.cuda.max_memory_allocated() - before
    print(f"one card, 32 MP factored: train {train_s:.3f} s, apply "
          f"{apply_s:.3f} s warm; peak {peak / 2**30:.3f} GiB", flush=True)
    record = {"cards": n, "one_card": {
        "dense_1mp_s": single_s, "factored_32mp_train_s": train_s,
        "factored_32mp_apply_s": apply_s, "factored_32mp_peak": peak},
        "meshes": {}}
    del f, big
    torch.cuda.empty_cache()

    def recompose(lab, plane):
        o = lab.copy()
        o[..., 0] = plane
        return lab_to_bgr_u8_np(o)

    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, arr in (("dense1", labs[0][None, ..., 0]),
                          ("dense2", np.stack([x[..., 0] for x in labs[1:]])),
                          ("cap", lab_big[..., 0])):
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], arr)
        meshes = [("1x%d" % n, (1, n), [
            dict(tag="dense", kind="dense", frames=paths["dense1"],
                 args=DENSE_ARGS, reps=3, refs=[0]),
            dict(tag="cap", kind="factored", frames=paths["cap"],
                 args=CAP_ARGS, reps=3)])]
        if n % 2 == 0 and n >= 4:
            meshes.append(("2x%d" % (n // 2), (2, n // 2), [
                dict(tag="dense", kind="dense", frames=paths["dense2"],
                     args=DENSE_ARGS, reps=3, refs=[1, 2])]))
        for name, mesh, jobs in meshes:
            t0 = time.perf_counter()
            res = run(tmp, name, mesh, "nccl", jobs)
            print(f"[{name}] over NCCL, one rank a card: launch "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            rec = record["meshes"][name] = {}
            for j in jobs:
                ranks = res[j["tag"]]
                same = all(np.array_equal(r["edits"][0], e) and
                           np.array_equal(r["edits"][0],
                                          ranks[0]["edits"][0])
                           for r in ranks for e in r["edits"])
                if j["kind"] == "dense":
                    db = [_psnr(recompose(labs[i], ranks[0]["edits"][0][k]),
                                single[i]) for k, i in enumerate(j["refs"])]
                else:
                    db = [_psnr(recompose(lab_big, ranks[0]["edits"][0][0]),
                                cap)]
                rec[j["tag"]] = {
                    "walls": [r["walls"].tolist() for r in ranks],
                    "train_s": [r["extra"][:, 0].tolist() for r in ranks]
                    if j["kind"] == "factored" else None,
                    "peak": [r["peak"] for r in ranks], "psnr": db,
                    "bitwise": bool(same),
                    "launches": [r["counts"][0] for r in ranks]}
                print(f"  {j['tag']}: walls a rank "
                      f"{[[round(w, 3) for w in r['walls']] for r in ranks]}"
                      + (f", train s {[[round(x, 3) for x in r['extra'][:, 0]] for r in ranks]}"
                         if j["kind"] == "factored" else "")
                      + f"; peak GiB {[round(r['peak'] / 2**30, 3) for r in ranks]}"
                      f"; {', '.join(f'{x:.2f}' for x in db)} dB from one "
                      f"card; repeats and ranks bitwise equal: {same}",
                      flush=True)
    return record


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"] and len(argv) == 2:
        return worker(argv[1])
    if argv:
        print("usage: python3 -m nle_tpu_torch.tools.sharded_scaling",
              file=sys.stderr)
        return 2
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("sharded_scaling: no card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    record = scaling()
    record["device"] = {"kind": torch.cuda.get_device_name(0),
                        "count": torch.cuda.device_count()}
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
