"""The Sinkhorn half-step's streaming floor on the card (port of
tools/bench_sk_dmaonly.py, with the per-width rates tools/bench_sk_width.py
asks for).

    python -m nle_tpu_torch.tools.bench_sk_dmaonly [--npad N] [--mpad M]
        [--sweeps S] [--seed K] [--chunks 512,1024]

K15 (csrc/sinkhorn.cu) is the TPU tool's probe on the half-step's own
bulk-copy sweep (K3/K4/K14's: persistent CTAs, rows staged by
cp.async.bulk into a ring of shared-memory slots, each CTA's rows whole
chunks of `chunk` rows), with parts of the work dropped, and returns the
probe's (8, max(mpad, chunk)) block:
    dmaonly  every row staged in shared memory, row 0 of each chunk summed
    wonly    w = phi t per row, folded by chunk (its first 1024 entries)
    wpart    w, then sum_c w_c^T phi_c
so K4's half-step time splits into the staging, the w pass and the s
pass (each line also gives its ratio to K4's time). One row per variant
and chunk (--chunks, default the JAX tool's CHUNKS 512,1024; wonly does
not trace on the TPU where min(1024, max(mpad, chunk)) != min(1024,
chunk), and its row says so). The JAX tool's NSLOTS (its DMA ring depth)
is the sweep's ring of slots, which sinkhorn_plan sizes from the shape.
Then the half-step kernels themselves at the same shape: K4 and K13 on
the f32 factor, K14 on its bf16 copy, K3 on its per-column int16 copy.
Each line gives ms per sweep (CUDA events over `sweeps` launches, the
least of three runs) and the rate in GB/s of the factor's bytes, as the
JAX tools report them. The defaults are the 1 MP main path's assembled
shape (npad 1,011,712 = 832 x 1216 padded to 2048 rows, mpad 640).

The factor is made on the card from --seed (normal, x 0.05, as the JAX
tool makes it); the kernels' times do not depend on its values. Needs an
NVIDIA GPU: there is no CPU fallback for a device measurement.
"""

from __future__ import annotations

import argparse
import json

from nle_tpu_torch.tools._sk_bench import card_line, int_list, ms_per_call

NPAD = 1_011_712
MPAD = 640
CHUNKS = (512, 1024)


def probe_table(torch, npad: int = NPAD, mpad: int = MPAD, sweeps: int = 10,
                seed: int = 0, chunks=CHUNKS) -> list[dict]:
    """One row per measurement: {"kernel", "what", "dtype", "bytes", "ms",
    "gb_s"}; ms and gb_s are None where the TPU probe does not trace. Runs
    K15's three variants at each chunk, then K4, K13, K14 and K3."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        PROBE_VARIANTS,
        check_probe,
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
        ms = None if fn is None else ms_per_call(torch, fn, sweeps)
        rows.append(dict(kernel=kernel, what=what,
                         dtype=str(Q.dtype).rsplit(".", 1)[-1], bytes=nbytes,
                         ms=ms, gb_s=None if ms is None else nbytes / ms / 1e6))

    for variant in PROBE_VARIANTS:
        for chunk in chunks:
            try:
                check_probe(npad, mpad, variant, chunk)
            except ValueError:
                add("K15", f"{variant} chunk={chunk}", phi, None)
                continue
            add("K15", f"{variant} chunk={chunk}", phi,
                lambda v=variant, c=chunk: sinkhorn_probe(phi, t, v, c))
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


def k4_ratio(rows, row) -> float | None:
    """The row's time over K4's half-step at the same shape."""
    k4 = next((r["ms"] for r in rows if r["kernel"] == "K4"), None)
    return None if k4 is None or row["ms"] is None else row["ms"] / k4


def format_rows(rows) -> list[str]:
    return [f"{r['kernel']:4s} {r['what']:26s} {r['dtype']:8s} "
            + ("does not trace on the TPU" if r["ms"] is None else
               f"{r['ms']:8.3f} ms/sweep {r['gb_s']:8.1f} GB/s "
               f"{k4_ratio(rows, r):6.3f} x K4")
            for r in rows]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--npad", type=int, default=NPAD)
    ap.add_argument("--mpad", type=int, default=MPAD)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunks", type=int_list, default=CHUNKS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sk_dmaonly: torch.cuda.is_available() is False; this "
              "measures an NVIDIA GPU.")
        return 2
    card = card_line()
    print(f"{card}; npad {args.npad}, mpad {args.mpad}")
    rows = probe_table(torch, args.npad, args.mpad, args.sweeps, args.seed,
                       args.chunks)
    for line in format_rows(rows):
        print(line)
    print(json.dumps({"card": card, "npad": args.npad, "mpad": args.mpad,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
