"""`denoise` CLI (port of nle_tpu/cli/denoise.py) — positional contract
identical to the reference binary.

    python -m nle_tpu_torch.cli.denoise <image> <output> <# row samples>
        <# col samples> <hx> <hy> <# sinkhorn iterations> <# eigen vectors>
        <sigmaColor> <sigmaSpace> <shrinkFactor> [--device=cuda|cpu] [flags]

(reference src/denoise.cpp:13-50). Runs on the card unless --device=cpu.
"""

from __future__ import annotations

import sys

from nle_tpu_torch.cli.common import (
    done_line,
    add_common_flags,
    apply_common_flags,
    make_filter,
    maybe_dump_eigvecs,
    maybe_show,
    profiled,
    split_flags,
    validate_flags,
)

USAGE = (
    "Usage: {prog} <image> <output> <# row samples> <# col samples> <hx> <hy> "
    "<# sinkhorn iterations> <# eigen vectors> <sigmaColor> <sigmaSpace> "
    "<shrinkFactor>"
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = split_flags(argv)
    if len(pos) < 11:
        print(USAGE.format(prog="denoise"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0  # reference exits 0 on usage (src/denoise.cpp:15-18)

    err = validate_flags(flags)
    if err is None:
        try:
            image_path, output_path = pos[0], pos[1]
            n_row_samples, n_col_samples = int(pos[2]), int(pos[3])
            hx, hy = float(pos[4]), float(pos[5])
            n_sinkhorn_iter, n_eigen_vectors = int(pos[6]), int(pos[7])
            sigma_color, sigma_space = float(pos[8]), float(pos[9])
            shrink_factor = float(pos[10])
        except ValueError as e:
            err = f"Bad argument: {e}"
    if err is not None:
        print(err, file=sys.stderr)
        print(USAGE.format(prog="denoise"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0

    from nle_tpu_torch.cli.common import warn_inapplicable

    warn_inapplicable("nle-denoise", flags, ("reuse-delta",))
    apply_common_flags(flags)
    from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

    try:
        image = imread_bgr(image_path)
    except FileNotFoundError:
        print(f"Failed to read file from {image_path}", file=sys.stderr)
        return 0

    flt = make_filter(flags)
    with profiled(flags):
        # sigmas stay float: the reference passes doubles straight to
        # cv::bilateralFilter (src/denoise.cpp:29-30,40-42) — truncating
        # 7.5 -> 7 changes the aperture radius and every weight.
        flt.train_for_denoise(
            image, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, sigma_color, sigma_space,
        )
        maybe_dump_eigvecs(flt, flags)
        # Stdout parity: the reference prints each clamped eigenvalue while
        # building the shrink transform (src/filter.cpp:378-383). The CLI
        # reproduces those lines (C++ default float formatting: up to 6
        # significant digits) from float64 copies of S; the library
        # denoise stays print-free.
        import numpy as np

        eigvals = flt.trained.eigvals.cpu().numpy().astype(np.float64)
        for i, ev in enumerate(eigvals):
            print(f"eig {i} val: {min(ev, 1.0):.6g}")
        result = flt.denoise(image, shrink_factor, sigma_color, sigma_space)
    imwrite_bgr(output_path, result)
    if "save-filter" in flags:
        flt.trained.save(flags["save-filter"])
    print(done_line(flags))
    maybe_show(result, flags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
