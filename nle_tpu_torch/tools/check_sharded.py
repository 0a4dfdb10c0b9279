"""Check of the pixel-sharded trainers on a one-rank mesh (port of
tools/check_tpu_sharded.py).

    python -m nle_tpu_torch.tools.check_sharded [--device=cuda|cpu]

Joins a one-rank process group (NCCL on the card, gloo on the CPU; a
file:// init in a temporary directory) and runs, on numpy-made frames:

1. the phi-free sharded trainer (K8, K12, K1) against the single-card
   train_filter(streaming=True) on a 256x384 structured frame with
   8 10 300 30 10 8: S, |V| and the edit;
2. the factored sharded trainer and apply_filter_factored_sharded (K10,
   K11) against train_filter_factored and its own apply;
3. the dense sharded trainer (K1, K3 or K4, K6, K7) on the 832x1216
   structured frame (1 MP) with the rock2 parameters 20 30 500 10 50 50,
   under NLE_SINKHORN_INT16=auto (the int16 carrier on the card; =on on
   the CPU) and =off (f32), each timed warm (the best of two after a cold
   call), against the single-card dense route under the same carrier:
   whether the int16 V and S are bitwise the single card's (one rank runs
   the same calls), and the int16 edit's and S's distance from the f32
   body's.

Prints one JSON line; rc 0 when every gate holds (the JAX tool's: S within
1e-3, edits within 0.2, the int16 edit within 5 gray levels and its S
within 0.05 of f32's). On the CPU the dense phase takes a 128x192 frame.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

ARGS = (8, 10, 300.0, 30.0, 10, 8)
DENSE_ARGS = (20, 30, 500.0, 10.0, 50, 50)
WEIGHTS = [2.0, 3.0, 4.0, 1.0]


def _luma(h: int, w: int, seed: int = 0) -> np.ndarray:
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.tools.check_serving import structured_frame

    return bgr_to_lab_u8_np(structured_frame(h, w, seed=seed))[..., 0].astype(
        np.float32)


def run(device: str = "cuda") -> dict:
    import torch

    from nle_tpu_torch.models.factored import train_filter_factored
    from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
    from nle_tpu_torch.ops.transform import transform_eigenvalues
    from nle_tpu_torch.parallel.distributed import (
        file_init,
        initialize,
        shutdown,
    )
    from nle_tpu_torch.parallel.sharded import (
        apply_filter_factored_sharded,
        make_mesh,
        train_filter_sharded,
    )

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as tmp:
        dev = initialize(file_init(tmp), 1, 0, device=device)
        try:
            mesh = make_mesh(1, 1)
            chan = _luma(256, 384)
            V1, S1 = train_filter(chan, *ARGS, device=dev, streaming=True)
            Vs, Ss = train_filter_sharded(chan[None], *ARGS, mesh,
                                          streaming=True)
            s_diff = float((Ss[0] - S1).abs().max())
            v_diff = float((Vs[0].abs() - V1.abs()).abs().max())
            fS = transform_eigenvalues(S1, WEIGHTS)
            c = torch.from_numpy(chan).to(dev)
            edit_diff = float((apply_filter(Vs[0], fS, c)
                               - apply_filter(V1, fS, c)).abs().max())

            flts = train_filter_sharded(chan[None], *ARGS, mesh,
                                        streaming=True, factored=True)
            ff1 = train_filter_factored(chan, *ARGS, device=dev)
            out_f1 = ff1.apply(chan, transform_eigenvalues(ff1.eigvals,
                                                           WEIGHTS))
            out_fs = apply_filter_factored_sharded(
                flts[0], chan, transform_eigenvalues(flts[0].eigvals,
                                                     WEIGHTS), mesh)
            fact_diff = float(np.abs(out_fs - out_f1).max())

            shape = (832, 1216) if dev.type == "cuda" else (128, 192)
            L = _luma(*shape)
            walls, outs = {}, {}
            # The carrier: auto engages it on the card only; on the CPU
            # it is forced on, so both sides run it there too.
            carrier = "auto" if dev.type == "cuda" else "on"
            for mode in (carrier, "off"):
                os.environ["NLE_SINKHORN_INT16"] = mode
                best = None
                for rep in range(3):
                    t0 = time.perf_counter()
                    V, S = train_filter_sharded(L[None], *DENSE_ARGS, mesh)
                    sync()
                    wall = time.perf_counter() - t0
                    if rep:
                        best = wall if best is None else min(best, wall)
                walls[mode], outs[mode] = best, (V[0], S[0])
            os.environ["NLE_SINKHORN_INT16"] = carrier
            V1d, S1d = train_filter(L, *DENSE_ARGS, device=dev)
            del os.environ["NLE_SINKHORN_INT16"]
            Lt = torch.from_numpy(L).to(dev)
            fSd = transform_eigenvalues(outs["off"][1], WEIGHTS)
            edits = {k: apply_filter(v[0], fSd, Lt) for k, v in outs.items()}
            single = apply_filter(V1d, fSd, Lt)
            q_edit_diff = float((edits[carrier] - edits["off"]).abs().max())
            sq_diff = float((outs[carrier][1] - outs["off"][1]).abs().max())
            bitwise = bool(torch.equal(outs[carrier][0], V1d)
                           and torch.equal(outs[carrier][1], S1d))
            single_diff = float((edits[carrier] - single).abs().max())
        finally:
            shutdown()
    ok = (s_diff < 1e-3 and edit_diff < 0.2 and fact_diff < 0.2
          and np.isfinite(v_diff) and q_edit_diff < 5.0 and sq_diff < 0.05
          and single_diff < 0.2)
    return {
        "check": "sharded", "device": str(dev), "mesh": [1, 1],
        "s_diff": s_diff, "v_absdiff": v_diff, "edit_diff": edit_diff,
        "factored_edit_diff": fact_diff, "dense_shape": list(shape),
        "dense_wall_int16_s": walls[carrier],
        "dense_wall_f32_s": walls["off"],
        "int16_edit_diff": q_edit_diff, "int16_s_diff": sq_diff,
        "dense_vs_single_edit_diff": single_diff,
        "dense_bitwise_single": bitwise, "ok": bool(ok)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = "cuda"
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            print("usage: python -m nle_tpu_torch.tools.check_sharded "
                  "[--device=cuda|cpu]", file=sys.stderr)
            return 2
    res = run(device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
