"""Stream mode: train a stream of same-shape frames with each frame's host
work overlapping the device work of the next (port of
nle_tpu/models/batch.py).

One frame alternates host and device: stage 1 (f64 eigh, host) -> stage
2a (device) -> the carrier guard and the f64 chain (host) -> stage 2b
(device), so each side idles while the other works. Here frame i+1's
stage 2a is queued on the device (submit) before frame i's host chain
runs (finish), so the chain runs while the card sweeps Sinkhorn for the
next frame. All device work stays on the one current stream, so each
frame's kernels run in single mode's order and give single mode's bits;
the overlap is the host against the device. Nothing in submit waits for
the device: uploads are pinned and non-blocking, and rc and Sb are copied
back behind the frame's stage 2a with an event that finish waits on alone
(utils/transfer.py).

With a lookahead of L, L frames are in flight while another is submitted:
each holds its padded phi on the card, so `fits_pipeline` bounds L by the
card's memory; past that rule the frames train one after another through
train_filter, which may take the phi-free streaming stage 2.

No reference counterpart (the reference trains one filter per process
run); this is the serving-path extension of NLEFilter (models/filter.py).
"""

from __future__ import annotations

import os
from collections import deque

import numpy as np
import torch

from nle_tpu_torch.config import EPS, resolve_device
from nle_tpu_torch.models.filter import TrainedFilter
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import MAX_MPAD, padded_shape
from nle_tpu_torch.ops.pipeline import (
    DENSE_PEAK_PER_PHI_BYTE,
    finish_dense,
    grid_coords,
    host_stage1,
    pack_channel,
    pack_stage1,
    stream_bytes_limit,
    submit_dense,
    train_filter,
)
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.utils.logging import logger, stage
from nle_tpu_torch.utils.transfer import upload


def fits_pipeline(n_pixels: int, n_row_samples: int, n_col_samples: int,
                  lookahead: int = 1, *, device="cuda") -> bool:
    """Whether stream mode with `lookahead` frames in flight fits the card.

    phi = 4 npad mpad bytes, the padded f32 factor of one frame, with
    mpad from the p = n_row_samples x n_col_samples samples (the rank
    bucket never exceeds p). While a frame runs its stage 2a (at most
    DENSE_PEAK_PER_PHI_BYTE x phi, its own factor included), the
    `lookahead` frames in flight hold their factors (1 x phi each: the
    split layout's int16 copy is freed when submit returns, and the one
    stream reuses its block in order). The rule:

        (lookahead + DENSE_PEAK_PER_PHI_BYTE) x phi
            <= DENSE_PEAK_PER_PHI_BYTE x stream_bytes_limit(device),

    the right side being what the process can still allocate on the card
    (stream_bytes_limit is that over DENSE_PEAK_PER_PHI_BYTE). A guard
    retrain in finish stays inside it: the frame's split factor is freed
    before its assembled f32 stage 2a peaks. The filters the caller keeps
    (V, 4k B/pixel each) are the caller's, outside the rule. Past MAX_MPAD
    the dense stage cannot run at all. On the CPU the rule always fits, as
    resolve_streaming never streams there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return True
    npad, mpad = padded_shape(n_pixels, n_row_samples * n_col_samples)
    if mpad > MAX_MPAD:
        return False
    phi = 4 * npad * mpad
    return ((lookahead + DENSE_PEAK_PER_PHI_BYTE) * phi
            <= DENSE_PEAK_PER_PHI_BYTE * stream_bytes_limit(dev))


def train_filters_pipelined(channels, n_row_samples: int, n_col_samples: int,
                            hx: float, hy: float, n_sinkhorn_iter: int = 10,
                            n_eig_vectors: int = 5, *, device="cuda",
                            eps: float | None = None) -> list[TrainedFilter]:
    """Train one filter per channel (an iterable of same-shape (H, W)
    arrays) in stream mode. Returns TrainedFilters in packed order (perm
    set) on `device`, ready for NLEFilter(trained=...); the device work is
    finished when this returns."""
    dev = resolve_device(device)
    out = list(train_filters_iter(
        channels, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
        n_eig_vectors, device=dev, eps=eps))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out


def train_filters_iter(channels, n_row_samples: int, n_col_samples: int,
                       hx: float, hy: float, n_sinkhorn_iter: int = 10,
                       n_eig_vectors: int = 5, *, device="cuda",
                       eps: float | None = None,
                       lookahead: int | None = None,
                       reuse_delta: float | None = None):
    """Generator form of train_filters_pipelined: yields each channel's
    TrainedFilter, in order, as soon as its host chain is done and its
    stage 2b is queued (the eigvecs are being computed on the device).

    lookahead: how many frames are submitted ahead of the one being
    finished (default 1; NLE_STREAM_LOOKAHEAD when None), clamped to
    fits_pipeline.

    reuse_delta: opt-in warm start for frame streams. A frame whose mean
    absolute difference from the last TRAINED frame is <= reuse_delta
    yields that frame's TrainedFilter instead of training its own (the
    edit still runs on the frame's own channel: the y_cache reuse is
    content-checked). Comparing with the last trained frame, not the
    previous one, keeps drift from accumulating.

    The channels are pulled lazily: the first fixes the shape and the
    grid, and each further one is pulled when it is submitted."""
    dev = resolve_device(device)
    if eps is None:
        eps = EPS
    chan_it = iter(channels)
    try:
        first = np.asarray(next(chan_it))
    except StopIteration:
        return
    nrows, ncols = first.shape

    def validated():
        yield first
        for c in chan_it:
            c = np.asarray(c)
            if c.shape != (nrows, ncols):
                raise ValueError(
                    "pipelined training requires same-shape channels")
            yield c

    def near(chan, ref) -> bool:
        return (reuse_delta is not None and ref is not None
                and float(np.mean(np.abs(
                    chan.astype(np.float32, copy=False)
                    - ref.astype(np.float32, copy=False)))) <= reuse_delta)

    channels = validated()
    grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
    if not fits_pipeline(grid.n_pixels, n_row_samples, n_col_samples,
                         device=dev):
        # Past the rule stream mode would run out of memory where one
        # frame at a time succeeds (train_filter may stream phi-free):
        # train sequentially, losing the overlap but not the frames.
        logger.warning(
            "stream mode: %dx%d at %dx%d samples exceeds the lookahead "
            "capacity rule; training sequentially.", nrows, ncols,
            n_row_samples, n_col_samples)
        ref = last = None
        for chan in channels:
            if near(chan, ref):
                yield last
                continue
            if reuse_delta is not None:
                ref = chan
            packed_np, flat_u8 = pack_channel(chan, grid.perm)
            y_dev = upload(packed_np, dev)
            V, S = train_filter(
                chan, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
                n_eig_vectors, device=dev, eps=eps, grid=grid,
                pixel_order=False, packed_y=y_dev)
            last = TrainedFilter(V, S, nrows, ncols, perm=grid.perm,
                                 y_cache=None if flat_u8 is None
                                 else (flat_u8, y_dev))
            yield last
        return

    p = grid.n_samples
    rr, cc = grid_coords(grid, dev)
    sw, pw = bandwidth_weights(hx, hy)

    def submit(chan):
        """Host stage 1, then queue the frame's stage 2a."""
        Um64, lam64, m, mb = host_stage1(chan, grid, hx, hy, eps)
        packed_np, flat_u8 = pack_channel(chan, grid.perm)
        y_dev = upload(packed_np, dev)
        with stage("Nystrom approximation + Sinkhorn"):
            frame = submit_dense(
                y_dev.to(torch.float32), rr, cc,
                upload(pack_stage1(Um64, lam64, mb=mb), dev), sw, pw, Um64,
                lam64, p=p, m=m, mb=mb, n_sinkhorn_iter=n_sinkhorn_iter,
                eps=eps)
        return frame, (None if flat_u8 is None else (flat_u8, y_dev))

    def finish(state) -> TrainedFilter:
        """Wait for the frame's stage 2a (its event only), the guard and
        the host chain, then queue its stage 2b."""
        frame, y_cache = state
        V, S = finish_dense(frame, n_eig_vectors)
        return TrainedFilter(V, S, nrows, ncols, perm=grid.perm,
                             y_cache=y_cache)

    if lookahead is None:
        lookahead = int(os.environ.get("NLE_STREAM_LOOKAHEAD", "1"))
    look = max(1, int(lookahead))
    while look > 1 and not fits_pipeline(grid.n_pixels, n_row_samples,
                                         n_col_samples, look, device=dev):
        look -= 1
    if look != lookahead and lookahead > 1:
        logger.info("stream mode: lookahead clamped %d -> %d (phi "
                    "capacity)", lookahead, look)

    reuse = object()        # marks a frame that reuses the last filter
    pending = deque()
    ref = None              # channel of the last TRAINED frame
    last = None             # its TrainedFilter

    def pop_finish():
        nonlocal last
        item = pending.popleft()
        if item is not reuse:
            # FIFO: the reference frame, which precedes every frame that
            # reuses it, is finished first.
            last = finish(item)
        return last

    for chan in channels:
        if near(chan, ref):
            pending.append(reuse)
        else:
            if reuse_delta is not None:
                ref = chan
            pending.append(submit(chan))
        if len(pending) > look:
            yield pop_finish()
    while pending:
        yield pop_finish()
