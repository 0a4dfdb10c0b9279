"""`nle-apply` CLI (port of nle_tpu/cli/apply.py) — edit an image with a
previously trained filter.

    python -m nle_tpu_torch.cli.apply <filter.npz> <image> <output> <w1> [w2 ...]
    python -m nle_tpu_torch.cli.apply <filter.npz> <image> <output> --op=denoise [--shrink=2]

Beyond the reference (which retrains per edit, include/filter.hpp:52-53):
a filter saved by `--save-filter=` of either package's CLIs, or by
`TrainedFilter.save`/`FactoredFilter.save`, re-weights detail layers at
apply cost only; the factored kind is detected from the file.
`--op=denoise` runs the GLIDE application instead (shrunk eigenvalues on
the chroma planes, bilateral on L — src/filter.cpp:349-410). The image
must match the training image's size (src/filter.cpp:414-420). Runs on
the card unless --device=cpu.
"""

from __future__ import annotations

import sys

from nle_tpu_torch.cli.common import (
    done_line,
    add_common_flags,
    apply_common_flags,
    device_of,
    maybe_show,
    pop_op,
    split_flags,
    validate_flags,
    warn_inapplicable,
)

USAGE = "Usage: {prog} <filter.npz> <image> <output> <weight 1> [weight 2 ...]"

_APPLY_FLAG_DOC = """Apply-only flags:
  --op=enhance|denoise          application mode (denoise = GLIDE: shrunk
                                eigenvalues on chroma, bilateral on L;
                                weights are not used and may be omitted)
  --shrink=K                    denoise eigenvalue shrink exponent (default 2)
  --sigma-color=S --sigma-space=S   denoise bilateral parameters (default 10)"""


# Training-time flags the shared validator accepts but nle-apply cannot
# honor (there is no training here; the filter file fixes eps/solver/type).
_INAPPLICABLE = ("save-filter", "debug-eigvecs", "eps", "stage1", "reuse-delta",
                 "no-pallas", "factored", "precision")


def _pop_apply_flags(flags):
    """Extract the apply-only flags before the shared validator (which
    would reject them as unknown — they are meaningless on the training
    CLIs). Returns (op, shrink, sigma_color, sigma_space) or an error
    string."""
    op, err = pop_op(flags)
    if err is not None:
        return err
    vals = {}
    for name, default in (("shrink", 2.0), ("sigma-color", 10.0),
                          ("sigma-space", 10.0)):
        v = flags.pop(name, default)
        if op == "enhance" and v != default:
            return f"Flag --{name} only applies with --op=denoise"
        if isinstance(v, bool):  # bare `--shrink`: float(True) == 1.0 trap
            return f"Flag --{name} requires a number (--{name}=...)"
        try:
            vals[name] = float(v)
        except ValueError:
            return f"Flag --{name} requires a number (--{name}=...)"
    return op, vals["shrink"], vals["sigma-color"], vals["sigma-space"]


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = split_flags(argv)
    parsed = _pop_apply_flags(flags)
    err = parsed if isinstance(parsed, str) else validate_flags(flags)
    op, shrink, sigma_color, sigma_space = (
        ("enhance", 2.0, 10.0, 10.0) if isinstance(parsed, str) else parsed)
    # Denoise ignores detail weights (reference denoise signature,
    # src/denoise.cpp:22-31), so the weight positionals become optional.
    min_pos = 3 if op == "denoise" else 4
    if err is None and len(pos) < min_pos:
        print(USAGE.format(prog="nle-apply"), file=sys.stderr)
        print(_APPLY_FLAG_DOC, file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0

    weights = []
    if err is None:
        try:
            filter_path, image_path, output_path = pos[0], pos[1], pos[2]
            if op == "denoise":
                # GLIDE uses shrink, not detail weights (reference denoise
                # signature, src/denoise.cpp:22-31) — don't require extra
                # positionals to parse as floats, but don't drop them
                # silently either.
                if pos[3:]:
                    print("nle-apply: --op=denoise ignores the weight "
                          "positionals " + " ".join(pos[3:]),
                          file=sys.stderr)
            else:
                weights = [float(w) for w in pos[3:]]
        except ValueError as e:
            err = f"Bad argument: {e}"
    if err is not None:
        print(err, file=sys.stderr)
        print(USAGE.format(prog="nle-apply"), file=sys.stderr)
        print(_APPLY_FLAG_DOC, file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0

    warn_inapplicable("nle-apply", flags, _INAPPLICABLE)
    for k in _INAPPLICABLE:
        flags.pop(k, None)
    apply_common_flags(flags)
    from nle_tpu_torch.config import resolve_device
    from nle_tpu_torch.models.filter import NLEFilter, load_filter
    from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

    # The device first: --device=cuda without a card raises here, not as a
    # filter that failed to load.
    device = resolve_device(device_of(flags))
    try:
        trained = load_filter(filter_path, device)
    except FileNotFoundError:
        print(f"Failed to read filter from {filter_path}", file=sys.stderr)
        return 0
    except Exception as e:  # corrupt/invalid .npz
        print(f"Failed to read filter from {filter_path}: {e}",
              file=sys.stderr)
        return 0
    try:
        image = imread_bgr(image_path)
    except FileNotFoundError:
        print(f"Failed to read file from {image_path}", file=sys.stderr)
        return 0

    flt = NLEFilter(trained=trained, device=device)
    try:
        if op == "denoise":
            result = flt.denoise(image, shrink, sigma_color=sigma_color,
                                 sigma_space=sigma_space)
        else:
            result = flt.enhance(image, weights)
    except ValueError as e:  # size-mismatch guard (src/filter.cpp:414-420)
        print(str(e), file=sys.stderr)
        return 0
    imwrite_bgr(output_path, result)
    print(done_line(flags))
    maybe_show(result, flags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
