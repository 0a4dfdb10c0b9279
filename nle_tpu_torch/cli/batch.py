"""Batch CLI (port of nle_tpu/cli/batch.py, the `nle-batch` console
script) — pipelined multi-image enhancement/denoise on the card (no
reference counterpart: the reference binary trains one filter per process
run, reference src/enhance.cpp:33-49).

    python -m nle_tpu_torch.cli.batch <output dir> <# row samples>
        <# col samples> <hx> <hy> <# sinkhorn iterations>
        <# eigen vectors> <w1,w2,...> <image> [image ...] [--device=cuda|cpu]
    python -m nle_tpu_torch.cli.batch --op=denoise <output dir> ...
        <# eigen vectors> <sigmaColor,sigmaSpace,shrinkFactor>
        <image> [image ...]

Same training/edit semantics per image as the enhance / denoise CLIs
(enhance: train on the Lab L channel, polynomial detail-layer reweighting;
denoise: train on the bilateral-prefiltered L, shrunk-eigenvalue spectral
filter on the chroma planes — reference src/filter.cpp:349-410), but the
frames ride stream mode (models/batch.py): image i+1's stage 2a is queued
on the device while image i's host-f64 chain runs, and each frame's edit
is queued from a consumer thread on the same default stream. The 8th
positional is ONE comma-joined argument (the trailing variadic slot
belongs to the input images here): detail-layer weights for enhance,
`sigmaColor,sigmaSpace,shrinkFactor` for --op=denoise. Runs on the card
unless --device=cpu (and raises without a card).

Images of different sizes are grouped by shape and pipelined per group
(the pipeline requires same-shape channels). Unreadable inputs print the
reference's "Failed to read file from ..." message and are skipped; the
run continues (exit 0, matching the reference CLI's never-fail contract).
"""

from __future__ import annotations

import os
import sys

from nle_tpu_torch.cli.common import (
    add_common_flags,
    apply_common_flags,
    device_of,
    pop_op,
    profiled,
    split_flags,
    validate_flags,
    warn_inapplicable,
)

USAGE = (
    "Usage: {prog} <output dir> <# row samples> <# col samples> <hx> <hy> "
    "<# sinkhorn iterations> <# eigen vectors> <w1,w2,...> <image> "
    "[image ...]\n"
    "       {prog} --op=denoise <output dir> ... <# eigen vectors> "
    "<sigmaColor,sigmaSpace,shrinkFactor> <image> [image ...]"
)

# Flags that configure per-image training internals the pipelined trainer
# does not expose (it is the float32 kernel path by construction).
_INAPPLICABLE = ("precision", "no-pallas", "factored", "stage1",
                 "save-filter", "debug-eigvecs", "show")


def _out_path(out_dir: str, image_path: str, op: str) -> str:
    stem = os.path.splitext(os.path.basename(image_path))[0]
    return os.path.join(out_dir, f"{stem}-{op}d.png")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, flags = split_flags(argv)
    if len(pos) < 9:
        print(USAGE.format(prog="nle-batch"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        print("  --op=enhance|denoise          edit operation per image "
              "(default enhance)", file=sys.stderr)
        return 0  # usage exits 0, like the reference CLIs

    op, err = pop_op(flags)
    if err is None:
        err = validate_flags(flags)
    if err is None:
        try:
            out_dir = pos[0]
            n_row_samples, n_col_samples = int(pos[1]), int(pos[2])
            hx, hy = float(pos[3]), float(pos[4])
            n_sinkhorn_iter, n_eig_vectors = int(pos[5]), int(pos[6])
            weights = [float(w) for w in pos[7].split(",")]
            if op == "denoise" and len(weights) != 3:
                raise ValueError(
                    "--op=denoise takes exactly "
                    "sigmaColor,sigmaSpace,shrinkFactor in the weights slot")
            image_paths = pos[8:]
        except ValueError as e:
            err = f"Bad argument: {e}"
    if err is not None:
        print(err, file=sys.stderr)
        print(USAGE.format(prog="nle-batch"), file=sys.stderr)
        print(add_common_flags(), file=sys.stderr)
        return 0

    warn_inapplicable("nle-batch", flags, _INAPPLICABLE)

    apply_common_flags(flags)
    import numpy as np

    from nle_tpu_torch.config import resolve_device
    from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

    # Before any file is read: --device=cuda without a card raises here.
    device = resolve_device(device_of(flags))

    os.makedirs(out_dir, exist_ok=True)
    loaded: list[tuple[str, np.ndarray, str]] = []
    used_out: set[str] = set()
    for path in image_paths:
        try:
            img = imread_bgr(path)
        except FileNotFoundError:
            print(f"Failed to read file from {path}", file=sys.stderr)
            continue
        # Same-stem inputs (dir1/a.png dir2/a.png, a.png a.jpg) would map
        # to one output name and silently clobber each other — suffix
        # collisions with a counter instead.
        out_name = _out_path(out_dir, path, op)
        if out_name in used_out:
            root, ext = os.path.splitext(out_name)
            idx = 2
            while f"{root}-{idx}{ext}" in used_out:
                idx += 1
            out_name = f"{root}-{idx}{ext}"
            print(f"nle-batch: output name collision for {path}; writing "
                  f"{out_name}", file=sys.stderr)
        used_out.add(out_name)
        loaded.append((path, img, out_name))

    # Group by shape (the pipeline needs same-shape channels), preserving
    # first-seen order of groups and input order within each group.
    groups: dict[tuple, list[tuple[str, np.ndarray, str]]] = {}
    for item in loaded:
        groups.setdefault(item[1].shape, []).append(item)

    from concurrent.futures import ThreadPoolExecutor

    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.models.batch import train_filters_iter
    from nle_tpu_torch.models.filter import NLEFilter

    eps = float(flags["eps"]) if "eps" in flags else 1e-10
    reuse_delta = (float(flags["reuse-delta"])
                   if "reuse-delta" in flags else None)
    n_done = 0
    if op == "denoise":
        from nle_tpu_torch.color.bilateral import bilateral_filter_u8
        from nle_tpu_torch.utils.transfer import Fetch, upload

        sigma_color, sigma_space, shrink_factor = weights

    with profiled(flags):
        for shape, items in groups.items():
            # One Lab conversion per image (the edit reuses it via
            # seed_lab_cache — recomputing per edit would double the single
            # host core's LUT work); for denoise the bilateral-prefiltered
            # L is both the training channel and the output L plane
            # (reference src/filter.cpp:521-538), so it too is computed
            # once and threaded through.
            labs = [bgr_to_lab_u8_np(img) for _, img, _ in items]
            if op == "denoise":
                bilats = [
                    Fetch(bilateral_filter_u8(
                        upload(np.ascontiguousarray(lab[..., 0]), device),
                        -1, sigma_color, sigma_space)).result()
                    for lab in labs]
                channels = [bl.astype(np.float32) for bl in bilats]
            else:
                channels = [lab[..., 0].astype(np.float32) for lab in labs]

            # Consumer threads run each frame's edit as its filter yields:
            # the apply queues on the default stream the trainer is
            # already queueing on, and the result fetch + Lab round trip +
            # PNG write ride pool threads under the next frame's device
            # work. The main thread stays training-only.
            def run_edit(i, flt):
                path, img, out_name = items[i]
                f = NLEFilter(trained=flt, device=device)
                f.seed_lab_cache(img, labs[i])
                if op == "denoise":
                    result = f.denoise(img, shrink_factor, sigma_color,
                                       sigma_space, bilateral_L=bilats[i])
                else:
                    result = f.enhance(img, weights)
                imwrite_bgr(out_name, result)

            with ThreadPoolExecutor(4) as ex:
                futs = [
                    ex.submit(run_edit, i, flt)
                    for i, flt in enumerate(train_filters_iter(
                        channels, n_row_samples, n_col_samples, hx, hy,
                        n_sinkhorn_iter, n_eig_vectors, device=device,
                        eps=eps, reuse_delta=reuse_delta))
                ]
                for f in futs:
                    f.result()
            n_done += len(items)
            print(f"{len(items)} image(s) at {shape[1]}x{shape[0]} -> "
                  f"{out_dir}", file=sys.stderr)
    print("Done." if n_done else "No images processed.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
