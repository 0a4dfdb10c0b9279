"""Does staging each sub-tile as several concurrent copies raise the
streaming rate? (port of tools/bench_sk_2stream.py)

    python -m nle_tpu_torch.tools.bench_sk_2stream [--npad N] [--mpad M]
        [--sweeps S] [--seed K] [--streams 1,2,4] [--chunks 1024,2048]

K19 (csrc/sinkhorn_ab.cu) is the TPU tool's probe: a persistent grid
stages the factor through a double-buffered shared-memory ring, each
sub-tile as `streams` 1D bulk copies completing on an mbarrier (the
port's first TMA-class copy: 16-byte addresses and sizes), and returns
the (8, mpad) block whose row 0 is the chunks' first rows summed. The
table gives ms per sweep, GB/s of the factor's bytes and each row's ratio
to K15 dmaonly and to torch.mv on the same factor. Defaults are the JAX
tool's: n = 1,000,000 padded to 2048 rows, m = 640, phi normal x 0.05
made on the card from --seed, 10 sweeps, streams 1, 2, 4 at chunks 1024
and 2048. Needs an NVIDIA GPU.
"""

from __future__ import annotations

from nle_tpu_torch.tools import _sk_bench as B

NPAD = B.padded(B.N_PIXELS, 2048)
STREAMS = (1, 2, 4)
CHUNKS = (1024, 2048)


def stream_table(torch, npad: int = NPAD, mpad: int = B.M_COLS,
                 sweeps: int = 10, seed: int = 0, streams=STREAMS,
                 chunks=CHUNKS) -> list[dict]:
    """K19 at each (streams, chunk), then the yardsticks."""
    from nle_tpu_torch.ops.kernels.sinkhorn_ab_kernel import sinkhorn_2stream

    B.require_card(torch, "bench_sk_2stream")
    phi, t = B.make_factor(torch, npad, mpad, seed, 0.0)
    rows = []
    for ns in streams:
        for chunk in chunks:
            rows.append(B.timed_row(
                torch, "K19", f"streams={ns} chunk={chunk}",
                "sinkhorn_ab_2stream", phi,
                lambda s=ns, c=chunk: sinkhorn_2stream(phi, t, s, c), sweeps))
    return B.with_yardsticks(torch, rows, phi, t, sweeps)


def main(argv=None) -> int:
    return B.tool_main(argv, "bench_sk_2stream", __doc__, NPAD, 10,
                       stream_table, {"streams": (STREAMS, B.int_list),
                                      "chunks": (CHUNKS, B.int_list)})


if __name__ == "__main__":
    raise SystemExit(main())
