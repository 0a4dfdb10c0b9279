"""One rank of tests/test_torch_sharded.py's gloo-CPU runs of the port's
pixel-sharded trainers (nle_tpu_torch/parallel/sharded.py).

    python tests/torch_sharded_worker.py --nproc=N --pid=I --init=METHOD \
        --shape=D,P --dir=DIR

reads DIR/inputs.npz (the test's numpy-made frames), runs every case on a
(D, P) mesh and writes what this rank got to DIR/rank<I>.npz.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ARGS = (3, 4, 50.0, 30.0, 10, 5)
CROP_ARGS = (6, 8, 300.0, 30.0, 10, 8)
MIXED_ARGS = (5, 6, 3000.0, 300.0, 6, 4)
GUARD_ARGS = (10, 10, 5.0, 30.0, 10, 5)
WEIGHTS = [2.0, 3.0, 4.0, 1.0]


def main() -> int:
    opts = dict(a[2:].split("=", 1) for a in sys.argv[1:])
    n_data, n_pixel = (int(x) for x in opts["shape"].split(","))
    import torch

    from nle_tpu_torch.ops.transform import transform_eigenvalues
    from nle_tpu_torch.parallel import sharded
    from nle_tpu_torch.parallel.distributed import initialize, shutdown

    initialize(opts["init"], int(opts["nproc"]), int(opts["pid"]),
               device="cpu")
    inputs = np.load(os.path.join(opts["dir"], "inputs.npz"))
    batch, crops, mixed = inputs["batch"], inputs["crops"], inputs["mixed"]
    out: dict = {}
    try:
        mesh = sharded.make_mesh(n_data, n_pixel)
        rank = mesh.rank

        def train(tag, frames, args, **kw):
            mesh.psum_log = []
            res = sharded.train_filter_sharded(frames, *args, mesh, **kw)
            out[f"{tag}_psum"] = np.array(mesh.psum_log, np.int64)
            mesh.psum_log = None
            out[f"{tag}_nb_local"] = mesh.run_info["nb_local"]
            out[f"{tag}_rows"] = np.array(mesh.run_info["rows"])
            return res

        V, S = train("dense", batch, ARGS)
        out["dense_V"], out["dense_S"] = V.numpy(), S.numpy()
        out["dense_phib_shape"] = np.array(mesh.run_info["phib_shape"])
        fS = transform_eigenvalues(S[0], WEIGHTS)
        out["apply_out"] = sharded.apply_filter_sharded(
            V[0], fS, torch.from_numpy(batch[0]), mesh).numpy()

        os.environ["NLE_SINKHORN_INT16"] = "on"
        V, S = train("int16", crops, CROP_ARGS)
        del os.environ["NLE_SINKHORN_INT16"]
        out["int16_V"], out["int16_S"] = V.numpy(), S.numpy()
        out["int16_crush"] = np.array(
            [mesh.run_info["crush"][i] for i in sorted(
                mesh.run_info["crush"])])

        V, S = train("stream", batch, ARGS, streaming=True)
        out["stream_V"], out["stream_S"] = V.numpy(), S.numpy()

        flts = train("fact", batch, ARGS, streaming=True, factored=True)
        out["fact_u8"] = np.array([f.y_train.dtype == np.uint8
                                   for f in flts])
        for i, f in enumerate(flts):
            out[f"fact_eig{i}"] = f.eigvals.numpy()
            fSi = transform_eigenvalues(f.eigvals, WEIGHTS)
            out[f"fact_out{i}"] = sharded.apply_filter_factored_sharded(
                f, batch[i], fSi, mesh)
        state = flts[0]._dev_sharded
        fS0 = transform_eigenvalues(flts[0].eigvals, WEIGHTS)
        again = sharded.apply_filter_factored_sharded(flts[0], batch[0], fS0,
                                                      mesh)
        reused = flts[0]._dev_sharded is state
        mesh2 = sharded.make_mesh(n_data, n_pixel)
        other = sharded.apply_filter_factored_sharded(flts[0], batch[0], fS0,
                                                      mesh2)
        out["fact_cache"] = np.array([
            state[0] is mesh, reused, np.array_equal(again, out["fact_out0"]),
            flts[0]._dev_sharded[0] is mesh2,
            np.array_equal(other, out["fact_out0"])])

        os.environ["NLE_M_BUCKET"] = "1"
        V, S = train("mixed", mixed, MIXED_ARGS)
        del os.environ["NLE_M_BUCKET"]
        out["mixed_V"], out["mixed_S"] = V.numpy(), S.numpy()
        # The carrier guard, made to decide as on the card (the carrier
        # engaged under auto): uniform noise trips it on the all-reduced
        # crush statistic, and the element retrains through the f32 body,
        # bitwise the f32 run's.
        engaged = sharded._sharded_int16
        sharded._sharded_int16 = lambda device: True
        try:
            Vg, Sg = sharded.train_filter_sharded(inputs["noise"],
                                                  *GUARD_ARGS, mesh)
        finally:
            sharded._sharded_int16 = engaged
        crush = mesh.run_info["crush"][0]
        retrained = mesh.run_info["retrained"][0]
        os.environ["NLE_SINKHORN_INT16"] = "off"
        Vf, Sf = sharded.train_filter_sharded(inputs["noise"], *GUARD_ARGS,
                                              mesh)
        del os.environ["NLE_SINKHORN_INT16"]
        out["guard"] = np.array([crush, retrained, torch.equal(Vg, Vf),
                                 torch.equal(Sg, Sf)], np.float64)
        out["host_work"] = np.array([mesh.host_work["stage1"],
                                     mesh.host_work["chain"]])

        errors = []
        for kw in (dict(factored=True),
                   dict(streaming=True, factored=True, dtype=torch.float64),
                   dict(streaming=True, dtype=torch.float64)):
            try:
                sharded.train_filter_sharded(batch, *ARGS, mesh, **kw)
                errors.append("")
            except ValueError as e:
                errors.append(str(e))
        out["errors"] = np.array(errors)
    finally:
        shutdown()
    np.savez(os.path.join(opts["dir"], f"rank{rank}.npz"), **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
