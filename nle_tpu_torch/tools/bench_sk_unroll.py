"""The 2x-unrolled half-step against the production one on the card (port
of tools/bench_sk_unroll.py).

    python -m nle_tpu_torch.tools.bench_sk_unroll [--npad N] [--mpad M]
        [--sweeps S] [--seed K] [--chunks 512,1024]

K16 (csrc/sinkhorn_ab.cu) is the TPU tool's `_kernel_unroll`: a 4-slot
cp.async ring, two sub-tiles consumed a step with independent chains, the
TPU's chunk partials summed in 8 stripes. The table times K4 (the
production f32 half-step the JAX tool calls "manual chunk=1024") and K16
at each chunk, then K15 dmaonly and torch.mv on the same factor as
yardsticks: ms per sweep, GB/s of the factor's bytes, and each row's ratio
to both. Defaults are the JAX tool's: n = 1,000,000 padded to 4096 rows,
m = 640, phi normal x 0.05 + 0.1 made on the card from --seed, 20 sweeps.
Needs an NVIDIA GPU: there is no CPU fallback for a device measurement.
"""

from __future__ import annotations

from nle_tpu_torch.tools import _sk_bench as B

NPAD = B.padded(B.N_PIXELS, 4096)
CHUNKS = (512, 1024)


def unroll_table(torch, npad: int = NPAD, mpad: int = B.M_COLS,
                 sweeps: int = 20, seed: int = 0,
                 chunks=CHUNKS) -> list[dict]:
    """K4, then K16 at each chunk, then the yardsticks."""
    from nle_tpu_torch.ops.kernels.sinkhorn_ab_kernel import sinkhorn_unroll
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import sinkhorn_halfstep

    B.require_card(torch, "bench_sk_unroll")
    phi, t = B.make_factor(torch, npad, mpad, seed, 0.1)
    rows = [B.timed_row(torch, "K4", "manual (production f32)",
                        "sinkhorn_halfstep_f32", phi,
                        lambda: sinkhorn_halfstep(phi, t, 1e-10), sweeps)]
    for chunk in chunks:
        rows.append(B.timed_row(
            torch, "K16", f"unroll2 chunk={chunk}", "sinkhorn_ab_unroll", phi,
            lambda c=chunk: sinkhorn_unroll(phi, t, 1e-10, c), sweeps))
    return B.with_yardsticks(torch, rows, phi, t, sweeps)


def main(argv=None) -> int:
    return B.tool_main(argv, "bench_sk_unroll", __doc__, NPAD, 20,
                       unroll_table, {"chunks": (CHUNKS, B.int_list)})


if __name__ == "__main__":
    raise SystemExit(main())
