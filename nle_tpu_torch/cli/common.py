"""Shared CLI plumbing (port of nle_tpu/cli/common.py): named flags layered
on the reference's positional contract, the filter options they select,
and the debug outputs.

The flags are nle_tpu's, with --device=cuda|cpu in place of
--platform=cpu|tpu (the card by default, and no fallback: --device=cuda
without a card raises), --profile writing a torch.profiler trace, and
--no-pallas selecting the plain PyTorch route (no hand-written kernel).
"""

from __future__ import annotations

import contextlib
import os
import sys

_FLAG_DOC = """Optional named flags (extensions beyond the reference CLI):
  --precision=float32|float64   compute dtype (float64: the plain PyTorch
                                float64 route)
  --eps=EPS                     eigenvalue/reciprocal cutoff override
  --no-pallas                   plain PyTorch route (no hand-written kernel)
  --factored                    V-free factored filter (capacity mode: the
                                (N, k) eigvec matrix is never built; edits
                                recompute affinities per apply)
  --save-filter=PATH            save trained filter (V, S) to .npz
  --debug-eigvecs=DIR           dump min-max-rescaled eigenvector images
  --device=cuda|cpu             run on the card (default) or the CPU
  --profile=DIR                 write a torch.profiler trace of the run
  --check-nans                  abort on NaN in any stage output
  --stage1=host64|topk|device   Ka eigensolver (topk = the reference's
                                USE_SPECTRA iterative solver)
  --reuse-delta=D               (nle-batch) temporal warm-start: a frame
                                whose mean |L delta| vs the last trained
                                frame is <= D reuses that frame's filter
                                (opt-in; trades filter freshness for
                                throughput on near-static streams)
  --show                        display the result in a blocking window
                                (the reference's imshow/waitKey end
                                behavior; needs a display)
  --verbose                     stage progress + timings on stderr"""


# Flags that require `--name=value`; the rest are boolean switches.
_VALUE_FLAGS = frozenset(
    {"precision", "eps", "save-filter", "debug-eigvecs", "device",
     "profile", "stage1", "reuse-delta"})
_BOOL_FLAGS = frozenset({"no-pallas", "check-nans", "verbose", "factored",
                         "show"})


def add_common_flags() -> str:
    return _FLAG_DOC


def split_flags(argv):
    """Separate `--name[=value]` flags from positional args."""
    pos, flags = [], {}
    for a in argv:
        if a.startswith("--"):
            body = a[2:]
            if "=" in body:
                k, v = body.split("=", 1)
                flags[k] = v
            else:
                flags[body] = True
        else:
            pos.append(a)
    return pos, flags


def validate_flags(flags) -> str | None:
    """Reject unknown or malformed flags before any work: a silently
    ignored typo (--no-palas) would run a whole training with defaults."""
    for k, v in flags.items():
        if k not in _VALUE_FLAGS and k not in _BOOL_FLAGS:
            return f"Unknown flag --{k}"
        if k in _VALUE_FLAGS and v is True:
            return f"Flag --{k} requires a value (--{k}=...)"
        if k in _BOOL_FLAGS and v is not True:
            return f"Flag --{k} takes no value"
    if flags.get("stage1") not in (None, "host64", "topk", "device"):
        return (f"Flag --stage1={flags['stage1']} invalid "
                "(expected host64|topk|device)")
    if flags.get("precision") not in (None, "float32", "float64"):
        return (f"Flag --precision={flags['precision']} invalid "
                "(expected float32|float64)")
    if flags.get("device") not in (None, "cuda", "cpu"):
        return (f"Flag --device={flags['device']} invalid "
                "(expected cuda|cpu)")
    if "reuse-delta" in flags:
        try:
            if not float(flags["reuse-delta"]) >= 0:   # rejects NaN too
                raise ValueError
        except ValueError:
            return (f"Flag --reuse-delta={flags['reuse-delta']} invalid "
                    "(expected a nonnegative float)")
    return None


def pop_op(flags):
    """Extract the `--op=enhance|denoise` flag of the editing CLIs
    (nle-apply). Must run before validate_flags, which rejects --op as
    unknown. Returns (op, error message or None)."""
    op = flags.pop("op", "enhance")
    if op not in ("enhance", "denoise"):
        return op, f"Flag --op={op} invalid (expected enhance|denoise)"
    return op, None


def warn_inapplicable(prog: str, flags, names) -> None:
    """Warn on stderr about known flags the caller will ignore: a silently
    dropped --save-filter would let the user believe a file was written."""
    hit = sorted(set(flags) & set(names))
    if hit:
        print(f"{prog}: ignoring flag(s) not applicable here: "
              + ", ".join(f"--{f}" for f in hit), file=sys.stderr)


def device_of(flags) -> str:
    return flags.get("device", "cuda")


def apply_common_flags(flags) -> None:
    """Process flags that must act before anything is computed."""
    from nle_tpu_torch.config import set_check_nans

    set_check_nans(bool(flags.get("check-nans")))
    if flags.get("verbose"):
        import logging

        logging.basicConfig(level=logging.DEBUG,
                            format="%(name)s %(levelname)s %(message)s")


@contextlib.contextmanager
def profiled(flags):
    """A torch.profiler trace around the run when --profile=DIR is given:
    DIR/trace.json (Chrome trace format), the card's activity included
    on --device=cuda."""
    out_dir = flags.get("profile")
    if not out_dir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_of(flags) == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def make_filter(flags):
    import torch

    from nle_tpu_torch.models.filter import NLEFilter

    kwargs = {}
    if "eps" in flags:
        kwargs["eps"] = float(flags["eps"])
    if flags.get("no-pallas"):
        kwargs["use_kernels"] = False
    if flags.get("factored"):
        kwargs["factored"] = True
    if "stage1" in flags:
        kwargs["stage1"] = flags["stage1"]
    if flags.get("precision") == "float64":
        kwargs["dtype"] = torch.float64
    return NLEFilter(device=device_of(flags), **kwargs)


def done_line(flags) -> str:
    """The reference's completion message, "Done. Press any key in result
    window to exit." (src/enhance.cpp:45, src/denoise.cpp:43), is true only
    when a blocking result window follows: verbatim under --show, just
    "Done." headless."""
    return ("Done. Press any key in result window to exit."
            if flags.get("show") else "Done.")


def maybe_show(result, flags, title: str = "Output image") -> None:
    """The reference's blocking imshow/waitKey end (src/enhance.cpp:47-49)
    under --show, where a display exists; headless by default."""
    if not flags.get("show"):
        return
    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")
            or sys.platform == "darwin"):
        # cv2.imshow can abort (not raise) without a display: probe first.
        print("--show: no display available; the output was written to "
              "disk.", file=sys.stderr)
        return
    try:
        import cv2

        cv2.imshow(title, result)
        cv2.waitKey(-1)
        cv2.destroyAllWindows()
    except Exception as e:
        print(f"--show: cannot open a display window ({e}); the output "
              "was written to disk.", file=sys.stderr)


def maybe_dump_eigvecs(flt, flags) -> None:
    """Headless form of the reference's debug imshow of the first <= 5
    eigenvectors (src/filter.cpp:504-511): DIR/eigvec_<i>.png, and one
    stats line each on stderr."""
    out_dir = flags.get("debug-eigvecs")
    if not out_dir:
        return
    import numpy as np

    from nle_tpu_torch.utils.imageio import imwrite_bgr
    from nle_tpu_torch.utils.visualize import eigvec_images

    os.makedirs(out_dir, exist_ok=True)
    t = flt.trained
    if not hasattr(t, "eigvecs"):
        print("--debug-eigvecs: factored filters store no eigenvector "
              "matrix; skipping dumps.", file=sys.stderr)
        return
    V = t.eigvecs_pixel_order()
    S = t.eigvals.cpu().numpy()
    for i, img in enumerate(eigvec_images(t, V=V)):
        v = V[:, i]
        print(
            f"Eigvec {i} eigval: {S[i]} minCoeff: {v.min()} maxCoeff: {v.max()}",
            file=sys.stderr,
        )
        imwrite_bgr(os.path.join(out_dir, f"eigvec_{i}.png"),
                    np.repeat(img[..., None], 3, axis=-1))
