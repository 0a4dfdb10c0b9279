"""`enhance` CLI (port of nle_tpu/cli/enhance.py) — positional contract
identical to the reference binary.

    python -m nle_tpu_torch.cli.enhance <image> <output> <# row samples>
        <# col samples> <hx> <hy> <# sinkhorn iterations> <# eigen vectors>
        <w1> [w2 ...] [--device=cuda|cpu] [flags]

(reference src/enhance.cpp:12-52). Headless by default — the reference's
blocking imshow/waitKey is replaced by the file write; named flags
(cli/common.py) add filter saving, precision and route control, and
eigvec debug dumps. Runs on the card unless --device=cpu.
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
    "<# sinkhorn iterations> <# eigen vectors> <weight 1> <weight 2> "
    "<weight 3> <weight 4>"
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = split_flags(argv)
    if len(pos) < 9:
        print(USAGE.format(prog="enhance"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0  # reference exits 0 on usage (src/enhance.cpp:15-18)

    err = validate_flags(flags)
    if err is None:
        try:
            image_path, output_path = pos[0], pos[1]
            n_row_samples, n_col_samples = int(pos[2]), int(pos[3])
            hx, hy = float(pos[4]), float(pos[5])
            n_sinkhorn_iter, n_eigen_vectors = int(pos[6]), int(pos[7])
            weights = [float(w) for w in pos[8:]]
        except ValueError as e:
            err = f"Bad argument: {e}"
    if err is not None:
        print(err, file=sys.stderr)
        print(USAGE.format(prog="enhance"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0

    from nle_tpu_torch.cli.common import warn_inapplicable

    warn_inapplicable("nle-enhance", flags, ("reuse-delta",))
    apply_common_flags(flags)
    from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

    try:
        image = imread_bgr(image_path)
    except FileNotFoundError:
        print(f"Failed to read file from {image_path}", file=sys.stderr)
        return 0

    flt = make_filter(flags)
    with profiled(flags):
        # train + first edit in one flow: the apply rides in stage 2b.
        result = flt.train_and_enhance(
            image, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, weights,
        )
        maybe_dump_eigvecs(flt, flags)
    imwrite_bgr(output_path, result)
    if "save-filter" in flags:
        flt.trained.save(flags["save-filter"])
    print(done_line(flags))
    maybe_show(result, flags, "Enhanced image")
    return 0


if __name__ == "__main__":
    sys.exit(main())
