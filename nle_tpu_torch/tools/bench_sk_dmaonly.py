"""The Sinkhorn half-step's streaming floor on the card (port of
tools/bench_sk_dmaonly.py, with the per-width rates tools/bench_sk_width.py
asks for).

    python -m nle_tpu_torch.tools.bench_sk_dmaonly [--npad N] [--mpad M]

K15 (csrc/sinkhorn.cu) sweeps an f32 factor (npad, mpad) the way K4 does,
with parts of the work dropped:
    dmaonly  every row tile staged in shared memory, rows r % 32 == 0 summed
    wonly    w = phi t per row, no s
    wpart    w, then the partial s = phi^T w
so K4's time splits into the staging, the w pass and the s pass. Then the
half-step kernels themselves at the same shape: K4 and K13 on the f32
factor, K14 on its bf16 copy, K3 on its per-column int16 copy. Each line
gives ms per sweep (CUDA events over `sweeps` launches, the least of three
runs) and the rate in GB/s of the factor's bytes, as the JAX tools report
them. The defaults are the 1 MP main path's assembled shape (npad
1,011,712 = 832 x 1216 padded to 2048 rows, mpad 640).

The factor is made on the card from --seed (normal, x 0.05, as the JAX
tool makes it); the kernels' times do not depend on its values. Needs an
NVIDIA GPU: there is no CPU fallback for a device measurement.
"""

from __future__ import annotations

import argparse
import json
import subprocess

NPAD = 1_011_712
MPAD = 640


def _ms_per_call(torch, fn, sweeps: int, repeats: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(sweeps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / sweeps)
    return best


def probe_table(torch, npad: int = NPAD, mpad: int = MPAD, sweeps: int = 10,
                seed: int = 0) -> list[dict]:
    """One row per measurement: {"kernel", "what", "dtype", "bytes", "ms",
    "gb_s"}. Runs K15's three variants, then K4, K13, K14 and K3."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        PROBE_VARIANTS,
        quantize_int16,
        sinkhorn_halfstep,
        sinkhorn_halfstep_tiled,
        sinkhorn_probe,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("bench_sk_dmaonly measures the card: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randn((npad, mpad), generator=gen, device=dev) * 0.05
    t = torch.rand((mpad,), generator=gen, device=dev)
    rows = []

    def add(kernel, what, Q, fn):
        nbytes = Q.element_size() * Q.numel()
        ms = _ms_per_call(torch, fn, sweeps)
        rows.append(dict(kernel=kernel, what=what,
                         dtype=str(Q.dtype).rsplit(".", 1)[-1], bytes=nbytes,
                         ms=ms, gb_s=nbytes / ms / 1e6))

    for variant in PROBE_VARIANTS:
        add("K15", variant, phi, lambda v=variant: sinkhorn_probe(phi, t, v))
    add("K4", "half-step f32", phi, lambda: sinkhorn_halfstep(phi, t, 1e-10))
    add("K13", "half-step f32, TPU tiles", phi,
        lambda: sinkhorn_halfstep_tiled(phi, t, 1e-10))
    phi_bf = phi.to(torch.bfloat16)
    add("K14", "half-step bf16", phi_bf,
        lambda: sinkhorn_halfstep(phi_bf, t, 1e-10))
    del phi_bf
    q16, scale, _ = quantize_int16(phi)
    tq = (scale * t).contiguous()
    add("K3", "half-step int16", q16, lambda: sinkhorn_halfstep(q16, tq,
                                                                1e-10))
    return rows


def format_rows(rows) -> list[str]:
    return [f"{r['kernel']:4s} {r['what']:26s} {r['dtype']:8s} "
            f"{r['ms']:8.3f} ms/sweep {r['gb_s']:8.1f} GB/s" for r in rows]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npad", type=int, default=NPAD)
    ap.add_argument("--mpad", type=int, default=MPAD)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sk_dmaonly: torch.cuda.is_available() is False; this "
              "measures an NVIDIA GPU.")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"{card}; npad {args.npad}, mpad {args.mpad}")
    rows = probe_table(torch, args.npad, args.mpad, args.sweeps, args.seed)
    for line in format_rows(rows):
        print(line)
    print(json.dumps({"card": card, "npad": args.npad, "mpad": args.mpad,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
