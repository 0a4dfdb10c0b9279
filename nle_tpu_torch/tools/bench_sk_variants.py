"""The half-step's alternative formulations on the card (port of
tools/bench_sk_variants.py).

    python -m nle_tpu_torch.tools.bench_sk_variants [--npad N] [--mpad M]
        [--sweeps S] [--seed K] [--variants xonly,parts3d]
        [--tiles 1024,2048]

One block per row tile of the TPU grid, each variant the TPU kernel's
function: parts3d and mxu_row0 on K17 (tile partials, one accumulator in
tile order), vpu and xonly on K18 (products rounded on their own and tree
sums; x only), mxu on K13 (nle_tpu's `_kernel`). The table gives ms per
sweep, GB/s of the factor's bytes and each row's ratio to K15 dmaonly and
to torch.mv on the same factor (the last two rows). Defaults are the JAX
tool's: n = 1,000,000 padded to 2048 rows, m = 640, phi normal x 0.05 +
0.1 made on the card from --seed, 20 sweeps, variants xonly and parts3d
at tiles 1024 and 2048 (--variants takes any of mxu, vpu, mxu_row0,
xonly, parts3d). Needs an NVIDIA GPU.
"""

from __future__ import annotations

from nle_tpu_torch.tools import _sk_bench as B

NPAD = B.padded(B.N_PIXELS, 2048)
VARIANTS = ("xonly", "parts3d")
TILES = (1024, 2048)
KERNEL = {"parts3d": "K17", "mxu_row0": "K17", "vpu": "K18", "xonly": "K18",
          "mxu": "K13"}


def launch_key(variant: str) -> str:
    return ("sinkhorn_halfstep_tiled" if variant == "mxu"
            else f"sinkhorn_ab_{variant}")


def variants_table(torch, npad: int = NPAD, mpad: int = B.M_COLS,
                   sweeps: int = 20, seed: int = 0, variants=VARIANTS,
                   tiles=TILES) -> list[dict]:
    """Each variant at each tile, then the yardsticks."""
    from nle_tpu_torch.ops.kernels.sinkhorn_ab_kernel import sinkhorn_variant

    B.require_card(torch, "bench_sk_variants")
    phi, t = B.make_factor(torch, npad, mpad, seed, 0.1)
    rows = []
    for variant in variants:
        for tile in tiles:
            rows.append(B.timed_row(
                torch, KERNEL[variant], f"{variant} tile={tile}",
                launch_key(variant), phi,
                lambda v=variant, r=tile: sinkhorn_variant(phi, t, 1e-10, v,
                                                           r), sweeps))
    return B.with_yardsticks(torch, rows, phi, t, sweeps)


def _names(text: str) -> tuple[str, ...]:
    return tuple(text.split(","))


def main(argv=None) -> int:
    return B.tool_main(argv, "bench_sk_variants", __doc__, NPAD, 20,
                       variants_table, {"variants": (VARIANTS, _names),
                                        "tiles": (TILES, B.int_list)})


if __name__ == "__main__":
    raise SystemExit(main())
