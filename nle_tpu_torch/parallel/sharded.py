"""Pixel-sharded training and application of the nonlocal filter over
torch.distributed (port of nle_tpu/parallel/sharded.py).

One process per rank. The ranks form a 2-D ("data", "pixel") grid
(`make_mesh`, a RankMesh): rank r sits in data row r // n_pixel at pixel
index r % n_pixel.

- "data": independent batch elements. A bucket group of elements is
  padded to a multiple of n_data by repeating its last element, and data
  row d trains the d-th contiguous chunk of it, one element after
  another. No collective crosses this axis but the bucket agreement (the
  kept ranks, gathered before the groups form) and the result assembly
  (each element broadcast from the row that trained it).
- "pixel": the N dimension. The rest pixels (N - p) are padded to a
  multiple of n_pixel (pad rows exact zeros: they are never built) and
  each rank builds and keeps only its own contiguous block of rows: its
  rows of phi_b, of the Sinkhorn vectors and of V. Every cross-shard sum
  of the JAX package's `psum` is one all_reduce over the pixel group
  through `_psum`, and every one is m-sized: the rest block's share of s
  in each Sinkhorn half-step, the int16 carrier's crush counts, the Sb
  gram, ap in the phi-free loop, V^T c and the factored apply's
  projection.

The p-sized work (the sampled rows' matvecs) is repeated on every rank of
a pixel group. Stage 1 (the float64 Ka eigensystem) and the host float64
chain run once per pixel group, on its first rank, and their outputs are
broadcast to the others (`_bcast_host`): a copy per rank could differ in
its last bits (OpenBLAS's thread count moves them) and give the shards of
one V different GrT, or different m.

The bodies run the port's kernels on the rank's rows, as the single-card
routes do (ops/pipeline.py):
- dense (`_train_2a`): K1 builds the rank's zero-tailed phi_b, the split
  Sinkhorn loop (sinkhorn_vectors_split) streams it through K3 (the int16
  carrier with a shard-local column scale) or K4 (f32), K6 the rest
  block's Sb term; stage 2b is K7 on the rank's phi_b;
- phi-free (`_train_2a_streaming`): K8 (K9 past Ppad 1792) inside the
  single-card loop (streaming_loop, its p-row projections in float64) and
  K12's float64 form for Sb; stage 2b is K1 times c, or nothing for a
  factored filter;
- the factored apply: K10 and K11 on the rank's rows.

Collectives: all_reduce and broadcast only, the two that both NCCL and
gloo take on the card's tensors (gloo's ranks share one card in
chip_smoke.py [15]); a gather is a broadcast from each rank of the group
in turn (`_gather_rows`), so one code serves both backends. Host arrays
(stage 1, the chain, configurations) ride on the CPU for gloo and on the
card for NCCL (`RankMesh.comm_device`).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch
import torch.distributed as dist

from nle_tpu_torch.config import EPS
from nle_tpu_torch.ops.affinity import affinity_matmul, bandwidth_weights
from nle_tpu_torch.ops.kernels._common import round_up
from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import (
    MATMUL_COL_ALIGN,
    scaled_gram,
    scaled_matmul,
)
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
    carrier_guard_decision,
    int16_forced_on,
    resolve_int16,
    resolve_int16_guard,
    sinkhorn_vectors_split,
    split_row_pad,
)
from nle_tpu_torch.ops.kernels.streaming_kernel import (
    pad_stream_operands,
    streaming_ap,
    streaming_atb,
    streaming_halfstep,
    streaming_loop,
    streaming_sample_gram,
)
from nle_tpu_torch.ops.pipeline import (
    _masked_top,
    _unpack_stage1,
    bucket_m,
    host_orthogonalize,
    ka_eigh_host64,
    ka_eigh_topk_host64,
    pack_channel,
    pack_stage1,
)
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.utils.logging import (
    carrier_log,
    logger,
    warn_truncation,
)
from nle_tpu_torch.utils.transfer import Fetch, upload

# The device of this process's rank, set by distributed.initialize.
_RANK_DEVICE: torch.device | None = None


def set_rank_device(device: torch.device | None) -> None:
    global _RANK_DEVICE
    _RANK_DEVICE = device


@dataclasses.dataclass(eq=False)
class RankMesh:
    """This rank's place in the ("data", "pixel") grid and its groups:
    `pixel_group` holds the ranks of its data row (the pixel axis),
    `data_group` the ranks at its pixel index (the data axis). What the
    trainers did on this rank through the mesh is kept on it: the payload
    sizes of every _psum while psum_log is a list, the host work
    (stage-1 eigensystems, host chains: a pixel group's first rank does
    both), and run_info, the last train's rows, phi_b block shape and per
    batch element the carrier's crush statistic and guard decision."""

    n_data: int
    n_pixel: int
    rank: int
    device: torch.device
    backend: str
    pixel_group: object
    data_group: object
    psum_log: list | None = None
    host_work: dict = dataclasses.field(
        default_factory=lambda: {"stage1": 0, "chain": 0})
    run_info: dict = dataclasses.field(default_factory=dict)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_pixel

    @property
    def pixel_index(self) -> int:
        return self.rank % self.n_pixel

    @property
    def pixel_ranks(self) -> list[int]:
        row = self.data_index * self.n_pixel
        return list(range(row, row + self.n_pixel))

    @property
    def comm_device(self) -> torch.device:
        """Where host arrays ride a collective: the card for NCCL, the CPU
        for gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def make_mesh(n_data: int = 1, n_pixel: int | None = None) -> RankMesh:
    """The ("data", "pixel") grid over every rank of the initialized
    process group (distributed.initialize): rank r at data row
    r // n_pixel, pixel index r % n_pixel. n_data x n_pixel must be the
    world size. Every rank must call it, in the same order as any other
    group it makes (each call makes n_data + n_pixel groups)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call nle_tpu_torch.parallel.distributed."
            "initialize on every rank first")
    world = dist.get_world_size()
    if n_pixel is None:
        n_pixel = world // n_data
    if n_data < 1 or n_pixel < 1 or n_data * n_pixel != world:
        raise ValueError(f"mesh ({n_data}, {n_pixel}) does not cover the "
                         f"{world} ranks")
    rank = dist.get_rank()
    backend = dist.get_backend()
    device = _RANK_DEVICE
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    pixel_group = data_group = None
    for d in range(n_data):
        g = dist.new_group(list(range(d * n_pixel, (d + 1) * n_pixel)))
        if d == rank // n_pixel:
            pixel_group = g
    for j in range(n_pixel):
        g = dist.new_group([d * n_pixel + j for d in range(n_data)])
        if j == rank % n_pixel:
            data_group = g
    return RankMesh(n_data, n_pixel, rank, device, backend, pixel_group,
                    data_group)


# -- collectives --------------------------------------------------------------

def _psum(t: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The one cross-shard sum: t all_reduced over the pixel group (a new
    tensor; t is left as it was). Records the payload in mesh.psum_log."""
    buf = t.clone(memory_format=torch.contiguous_format)
    if mesh.psum_log is not None:
        mesh.psum_log.append(int(buf.numel()))
    dist.all_reduce(buf, group=mesh.pixel_group)
    return buf


def _psum_prefix(v: torch.Tensor, mb: int, mesh: RankMesh) -> torch.Tensor:
    """v with its first mb entries summed over the pixel group. The rest
    block's share of s is zero past the rank bucket mb on every rank (phi_b's
    columns are exact zeros there), so only mb entries travel."""
    out = v.clone()
    out[:mb] = _psum(v[:mb], mesh)
    return out


def _broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    dist.broadcast(t, src=src, group=group)
    return t


def _gather_rows(shard: torch.Tensor, mesh: RankMesh) -> torch.Tensor:
    """The pixel group's equal-sized row shards stacked in pixel order,
    one broadcast from each rank of the group."""
    rows = shard.shape[0]
    out = shard.new_empty((rows * mesh.n_pixel, *shard.shape[1:]))
    for j, src in enumerate(mesh.pixel_ranks):
        part = out[j * rows:(j + 1) * rows]
        if j == mesh.pixel_index:
            part.copy_(shard)
        _broadcast(part, src, mesh.pixel_group)
    return out


def _bcast_host(arrays, mesh: RankMesh) -> list[np.ndarray]:
    """Host arrays from the pixel group's first rank to every rank of the
    group (the others pass None), as float64: a header of their shapes,
    then one payload."""
    dev = mesh.comm_device
    src = mesh.pixel_ranks[0]
    if mesh.pixel_index == 0:
        arrays = [np.asarray(a, np.float64) for a in arrays]
        head = [len(arrays)]
        for a in arrays:
            head += [a.ndim, *a.shape]
        size = torch.tensor([len(head)], dtype=torch.int64, device=dev)
        hdr = torch.tensor(head, dtype=torch.int64, device=dev)
        flat = np.concatenate([a.ravel() for a in arrays] + [np.zeros(1)])
        payload = torch.from_numpy(flat).to(dev)
    else:
        size = torch.empty(1, dtype=torch.int64, device=dev)
    _broadcast(size, src, mesh.pixel_group)
    if mesh.pixel_index != 0:
        hdr = torch.empty(int(size[0]), dtype=torch.int64, device=dev)
    head = _broadcast(hdr, src, mesh.pixel_group).tolist()
    shapes, i = [], 1
    for _ in range(head[0]):
        nd = head[i]
        shapes.append(tuple(head[i + 1:i + 1 + nd]))
        i += 1 + nd
    total = sum(int(np.prod(s)) for s in shapes) + 1
    if mesh.pixel_index != 0:
        payload = torch.empty(total, dtype=torch.float64, device=dev)
    flat = _broadcast(payload, src, mesh.pixel_group).cpu().numpy()
    out, at = [], 0
    for s in shapes:
        size_s = int(np.prod(s))
        out.append(flat[at:at + size_s].reshape(s))
        at += size_s
    return out


def all_gather_world(vec: np.ndarray, mesh: RankMesh) -> np.ndarray:
    """(world, len) rows of every rank's 1-D vec (the same length and dtype
    on every rank), one broadcast from each rank over the whole group."""
    vec = np.ascontiguousarray(vec)
    world = dist.get_world_size()
    out = torch.empty((world, vec.size), dtype=torch.from_numpy(vec).dtype,
                      device=mesh.comm_device)
    for r in range(world):
        if r == mesh.rank:
            out[r] = torch.from_numpy(vec)
        _broadcast(out[r], r, None)
    return out.cpu().numpy()


def _bcast_data(t: torch.Tensor, src_row: int, mesh: RankMesh) -> torch.Tensor:
    """t from data row src_row to every row, along this rank's data group
    (result assembly)."""
    if mesh.n_data > 1:
        _broadcast(t, src_row * mesh.n_pixel + mesh.pixel_index,
                   mesh.data_group)
    return t


def check_agreement(cfg, mesh: RankMesh, what: str,
                    group_digest=None) -> None:
    """Raise ValueError on every rank unless every rank passed the same cfg
    and, where group_digest is given, every rank of each pixel group the
    same digest (one all_gather of both): a rank that broke the contract
    would otherwise hang the others in the next collective."""
    cfg = np.asarray(cfg, np.float64)
    extra = np.zeros(0) if group_digest is None else group_digest
    rows = all_gather_world(np.concatenate([cfg, extra]), mesh)
    ncfg = cfg.size
    if not (rows[:, :ncfg] == rows[mesh.rank, :ncfg]).all():
        raise ValueError(f"{what} config mismatch across ranks: "
                         f"{rows[:, :ncfg]}")
    if group_digest is not None:
        groups = rows[:, ncfg:].reshape(mesh.n_data, mesh.n_pixel, -1)
        if not (groups == groups[:, :1]).all():
            raise ValueError(f"{what}: the ranks of a pixel group passed "
                             "different frames")


def frames_digest(arr: np.ndarray) -> np.ndarray:
    """Four 16-bit words of the SHA-256 of arr's bytes (exact as
    float64)."""
    raw = hashlib.sha256(np.ascontiguousarray(arr).tobytes()).digest()
    return np.frombuffer(raw[:8], np.uint16).astype(np.float64)


# -- the rank's rows ------------------------------------------------------------

def rest_rows(nb: int, mesh: RankMesh) -> tuple[int, int, int]:
    """(nb_local, lo, hi): the rank's block of the nb rest rows padded to a
    multiple of n_pixel, and its valid rows [lo, hi) (hi - lo < nb_local
    only on the last ranks, whose pad rows are never built)."""
    nb_local = -(-max(nb, 1) // mesh.n_pixel)
    lo = min(mesh.pixel_index * nb_local, nb)
    return nb_local, lo, min(lo + nb_local, nb)


def _coord_rest_arrays(grid, mesh: RankMesh) -> tuple[np.ndarray, np.ndarray]:
    """Row and column (float32, host) of the rank's valid rest pixels."""
    p = grid.n_samples
    _, lo, hi = rest_rows(grid.n_pixels - p, mesh)
    perm = grid.perm[p + lo:p + hi]
    return ((perm // grid.ncols).astype(np.float32),
            (perm % grid.ncols).astype(np.float32))


def _build_feats(grid, flat: np.ndarray, mesh: RankMesh):
    """(fa (p, 3), fb (hi - lo, 3)): the samples' features and the rank's
    valid rest rows', float32 on the rank's device; no rank holds the
    other ranks' rows."""
    p, ncols = grid.n_samples, grid.ncols
    _, lo, hi = rest_rows(grid.n_pixels - p, mesh)
    rr, cc = _coord_rest_arrays(grid, mesh)
    sel = grid.perm[:p]
    fa = np.stack([(sel // ncols).astype(np.float32),
                   (sel % ncols).astype(np.float32),
                   flat[:p].astype(np.float32)], axis=-1)
    fb = np.stack([rr, cc, flat[p + lo:p + hi].astype(np.float32)], axis=-1)
    return upload(fa, mesh.device), upload(fb, mesh.device)


# -- the int16 carrier on the pixel axis ----------------------------------------

def _sharded_int16(device: torch.device) -> bool:
    """Whether the dense sharded body streams the int16 carrier (K3):
    NLE_SINKHORN_INT16 auto (default) on the card only, as the JAX
    package's auto engages on TPU meshes only (on the CPU the f32 body is
    the comparison baseline); on/1/true on any device (the CPU through the
    plain K3); off never; anything else raises (resolve_int16)."""
    return resolve_int16() and (device.type == "cuda" or int16_forced_on())


def _sharded_guard_trips(crush: torch.Tensor) -> bool:
    """The carrier guard on the pixel group's all-reduced crush fraction
    (so every rank of the group decides alike), through the single-card
    policy carrier_guard_decision. Skips the fetch when the guard is
    off."""
    if resolve_int16_guard() is None:
        return False
    return carrier_guard_decision(float(crush), logger, "crush fraction",
                                  "retraining this element")


# -- stage 2a bodies ------------------------------------------------------------

def _local_gram(phib: torch.Tensor, cb: torch.Tensor, mb: int,
                mesh: RankMesh) -> torch.Tensor:
    """Sb's rest term: K6 on the rank's (phi_b, c) rows, all_reduced."""
    return _psum(scaled_gram(phib, cb[:, None])[:mb, :mb], mesh)


def _train_2a(Um, lam_m, Uinv, m: int, fa, fb, *, p: int, mb: int,
              nb_local: int, n_iter: int, eps: float, sw, pw,
              mesh: RankMesh, int16: bool):
    """The dense body on the rank's rows (nle_tpu's _train_2a, f32, and
    _train_2a_q, the int16 carrier): K1 builds the rank's phi_b block,
    zero-tailed to split_row_pad(nb_local) rows; the split Sinkhorn loop
    runs the p sampled rows as f32 matvecs on every rank and the block
    through K3 (int16, the rank's own column scale, the crush counts
    all_reduced) or K4 (f32), one all_reduce of the block's (mb,) share of
    s a half-step; K6 gives Sb's rest term. Returns (r_top, c_top, Sb,
    phi_b, c_b, crush)."""
    mpad = round_up(mb, 128)
    phib = affinity_matmul(fa, fb, Uinv, sw, pw,
                           out_rows=split_row_pad(nb_local))
    mesh.run_info["phib_shape"] = tuple(phib.shape)
    Um_pad = torch.nn.functional.pad(Um, (0, mpad - mb))
    lam_pad = torch.nn.functional.pad(lam_m, (0, mpad - mb))
    rp, cp, _, cb, crush = sinkhorn_vectors_split(
        Um_pad, lam_pad, phib, n_iter, eps, int16=int16,
        reduce_s=lambda v: _psum_prefix(v, mb, mesh),
        reduce_counts=lambda v: _psum(v, mesh))
    cphiu = _masked_top(cp, Um_pad, p, m)
    Sb = (cphiu.T @ cphiu)[:mb, :mb] + _local_gram(phib, cb, mb, mesh)
    return rp, cp, Sb, phib, cb, crush


def _train_2a_streaming(m: int, fa, fb, *, p: int, n_iter: int, eps: float,
                        sw, pw, mesh: RankMesh, stage1_64):
    """The phi-free body on the rank's rows (nle_tpu's
    _train_2a_streaming): the single-card loop streaming_loop (its p-row
    projections in float64, on stage1_64 = stage 1's float64 (Um, lam) on
    the rank's device) around K8 (K9 past Ppad 1792) on the rank's rows,
    each half-step's ap (p,) all_reduced in float64, after the s0 pass;
    K12's float64 form gives the rank's H, and its share of Sb's rest term,
    Uinv^T H Uinv in float64, is all_reduced. Returns (r_top, c_top
    float64, Sb (m, m) float64, c_rest) with c_rest the rank's valid
    rows."""
    fa_rows, fb_cols, mask = pad_stream_operands(fa, fb)
    q, qpad, ppad = fb.shape[0], fb_cols.shape[1], fa_rows.shape[1]

    def halfstep(u, unit_x=False):
        x, ap = streaming_halfstep(fa_rows, fb_cols, mask, u, sw, pw, eps,
                                   unit_x=unit_x)
        return x, _psum(ap[:p].double(), mesh)

    _, ap0 = halfstep(fa_rows.new_zeros((ppad,)), unit_x=True)
    if n_iter < 1:
        rp, cp = fa.new_ones((p,)), fa.new_zeros((p,))
        c_rest = fb_cols.new_zeros((qpad,))
    else:
        rp, _, cp, c_rest = streaming_loop(halfstep, ap0, *stage1_64, ppad,
                                           n_iter, eps)
    um64, lam64 = stage1_64
    cu = _masked_top(cp, um64, p, m)
    c_row = torch.nn.functional.pad(c_rest[:q], (0, qpad - q))[None]
    uinv64 = um64 / lam64[None, :]
    H = streaming_sample_gram(fa_rows, fb_cols, c_row, sw, pw)[:p, :p]
    Sb = cu.T @ cu + _psum(uinv64.T @ H @ uinv64, mesh)
    return rp, cp, Sb, c_rest[:q]


# -- the host float64 chain ------------------------------------------------------

def element_host_chain(rp64, cp64, sb, Um64, lam64, m: int, mb: int, k: int,
                       eps: float, dtype=np.float32):
    """One element's host float64 orthogonalization chain and the sampled
    rows of V, shared by the mesh and the multihost trainers. Returns
    (va_np (mb, 2k), Sq, GrT (m, k), top (p, k) in dtype)."""
    p = Um64.shape[0]
    va_np, Sq = host_orthogonalize(np.stack([rp64, cp64]), sb, Um64, lam64,
                                   m, mb, k, eps)
    GrT = va_np[:m, k:]
    Vu = (cp64[m:p, None] * Um64[m:]) @ GrT
    top = np.concatenate([va_np[:m, :k], Vu], axis=0).astype(np.dtype(dtype))
    return va_np, Sq, GrT, top


def factored_from_pieces(channel, grid, hx, hy, cp, c_rest, top, W, Sq):
    """A V-free FactoredFilter from the trainer's pieces (the mesh and the
    multihost factored paths): c = [c_top; c_rest] and the small
    matrices, on c's device. The u8 pack rule of models/factored.py holds:
    an 8-bit training channel stays uint8 in y_train."""
    from nle_tpu_torch.models.factored import FactoredFilter

    dev = c_rest.device
    y_train, _ = pack_channel(np.asarray(channel), grid.perm)

    def as_dev(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    return FactoredFilter(
        y_train=y_train, c=torch.cat([cp.to(torch.float32), c_rest]),
        v_head=as_dev(top, np.float64), w=as_dev(W, np.float64),
        eigvals=as_dev(Sq, np.float32), nrows=grid.nrows, ncols=grid.ncols,
        hx=float(hx), hy=float(hy), perm=grid.perm)


def _stage1_once(channel: np.ndarray, grid, hx, hy, eps: float,
                 solver: str, mesh: RankMesh):
    """Stage 1 of one frame on the pixel group's first rank, broadcast to
    the group: (Um64 (p, m), lam64 (m,))."""
    pieces = None
    if mesh.pixel_index == 0:
        mesh.host_work["stage1"] += 1
        fn = ka_eigh_topk_host64 if solver == "topk" else ka_eigh_host64
        Um64, lam64, _ = fn(
            channel[grid.sel_rows, grid.sel_cols].astype(np.float64),
            grid.sel_rows, grid.sel_cols, hx, hy, eps)
        pieces = [Um64, lam64]
    Um64, lam64 = _bcast_host(pieces, mesh)
    return Um64, lam64


def train_element(channel: np.ndarray, grid, Um64, lam64, *, m: int, mb: int,
                  k_chain: int, k_out: int, hx, hy, n_iter: int, eps: float,
                  streaming: bool, factored: bool, mesh: RankMesh, index=0):
    """Train one frame on this rank's pixel group: stage 2a on the rank's
    rows, the host chain on the group's first rank (broadcast), stage 2b on
    the rank's rows, and the rows gathered over the group. Returns (V
    (N, k_out) pixel order, S (k_out,)) on the rank's device, or a
    FactoredFilter."""
    dev = mesh.device
    p, n = grid.n_samples, grid.n_pixels
    nb = n - p
    nb_local, lo, hi = rest_rows(nb, mesh)
    mesh.run_info.update(nb_local=nb_local, rows=(lo, hi))
    sw, pw = bandwidth_weights(hx, hy)
    flat = np.asarray(channel).reshape(-1)[grid.perm]
    fa, fb = _build_feats(grid, flat, mesh)
    stage1 = upload(pack_stage1(Um64, lam64, mb=mb), dev)
    Um, lam_m, Uinv = _unpack_stage1(stage1, p)
    body = dict(p=p, mb=mb, n_iter=n_iter, eps=eps, sw=sw, pw=pw, mesh=mesh)
    if streaming:
        stage1_64 = [upload(np.ascontiguousarray(a, np.float64), dev)
                     for a in (Um64, lam64)]
        rp, cp, Sb, c_rest = _train_2a_streaming(
            m, fa, fb, p=p, n_iter=n_iter, eps=eps, sw=sw, pw=pw, mesh=mesh,
            stage1_64=stage1_64)
    else:
        int16 = _sharded_int16(dev)
        rp, cp, Sb, phib, cb, crush = _train_2a(
            Um, lam_m, Uinv, m, fa, fb, nb_local=nb_local, int16=int16,
            **body)
        retrained = bool(int16 and _sharded_guard_trips(crush))
        if retrained:
            del phib, cb
            rp, cp, Sb, phib, cb, _ = _train_2a(
                Um, lam_m, Uinv, m, fa, fb, nb_local=nb_local, int16=False,
                **body)
        if int16:
            value = float(crush)
            mesh.run_info.setdefault("crush", {})[index] = value
            mesh.run_info.setdefault("retrained", {})[index] = retrained
            carrier_log.info(
                "int16 carrier crush fraction %.4f (retrained: %s)", value,
                retrained, extra={"crush": value, "retrained": retrained})
    pieces = None
    if mesh.pixel_index == 0:
        mesh.host_work["chain"] += 1
        sb_fetch = Fetch(Sb)
        rp64 = Fetch(rp).result().astype(np.float64)
        cp64 = Fetch(cp).result().astype(np.float64)
        va_np, Sq, GrT, top = element_host_chain(
            rp64, cp64, lambda: sb_fetch.result(), Um64, lam64, m, mb,
            k_chain, eps, dtype=np.float64 if factored else np.float32)
        pieces = [va_np, Sq, top]
        if factored:
            pieces.append((Um64 / lam64[None, :]) @ GrT)
    pieces = _bcast_host(pieces, mesh)
    va_np, Sq, top = pieces[:3]
    if factored:
        c_all = _gather_rows(torch.nn.functional.pad(
            c_rest, (0, nb_local - (hi - lo))), mesh)[:nb]
        return factored_from_pieces(channel, grid, hx, hy, cp, c_all,
                                    top, pieces[3], Sq)
    grt = va_np[:, k_chain:k_chain + k_out].astype(np.float32)
    if streaming:
        B = Uinv @ upload(grt, dev)
        vb = c_rest[:, None] * affinity_matmul(fa, fb, B, sw, pw)
        vb = torch.nn.functional.pad(vb, (0, 0, 0, nb_local - (hi - lo)))
    else:
        grt_pad = torch.zeros((phib.shape[1], round_up(k_out,
                                                       MATMUL_COL_ALIGN)),
                              dtype=torch.float32, device=dev)
        grt_pad[:mb, :k_out] = upload(grt, dev)
        vb = scaled_matmul(phib, cb[:, None], grt_pad)[:nb_local, :k_out]
        del phib, cb
    V_rest = _gather_rows(vb.contiguous(), mesh)[:nb]
    V_packed = torch.cat([upload(top[:, :k_out].astype(np.float32), dev),
                          V_rest])
    V = V_packed[upload(grid.unpack_indices(), dev)]
    return V, upload(Sq[:k_out].astype(np.float32), dev)


# -- the mesh trainer -------------------------------------------------------------

STAGE1_SOLVERS = ("host64", "topk")


def _check_modes(streaming: bool, factored: bool, dtype) -> None:
    """The JAX trainer's refusals, in its order, then the port's: the
    sharded bodies compute in float32."""
    f32 = dtype in (torch.float32, np.float32) or (
        not isinstance(dtype, torch.dtype)
        and np.dtype(dtype) == np.float32)
    name = str(dtype).replace("torch.", "")
    if factored and not streaming:
        raise ValueError(
            "factored=True requires streaming=True (the dense path's "
            "sharded factor is the scaled phi, not the c vector).")
    if factored and not f32:
        raise ValueError(
            "factored=True is float32-only (models/factored.py); got "
            f"dtype {name}.")
    if streaming and not f32:
        raise ValueError(
            "streaming stage 2 is float32-only (the kernels compute in "
            f"f32); got dtype {name}.")
    if not f32:
        raise ValueError(
            f"the sharded trainers are float32-only; got dtype {name}.")


def train_filter_sharded(channels, n_row_samples: int, n_col_samples: int,
                         hx: float, hy: float, n_sinkhorn_iter: int,
                         n_eig_vectors: int, mesh: RankMesh, *,
                         eps: float | None = None, dtype=torch.float32,
                         streaming: bool = False, factored: bool = False,
                         stage1: str = "host64"):
    """Train filters for a batch of channels (B, H, W) over the mesh. Every
    rank calls it with the same batch and gets the same result.

    Returns (V (B, N, k) pixel order, S (B, k)) on the rank's device, k =
    min(n_eig_vectors, the batch's least kept rank); with factored=True
    (requires streaming=True) a list of V-free FactoredFilters, each with
    its own k = min(n_eig_vectors, m_i). Elements go in groups that share a
    rank bucket mb = bucket_m(m, p), in increasing mb; a group is padded to
    a multiple of the data axis by repeating its last element and data row
    d trains its d-th contiguous chunk. streaming=True runs the phi-free
    body (per-rank memory O(rows)); the dense body keeps the rank's
    phi_b."""
    _check_modes(streaming, factored, dtype)
    if stage1 not in STAGE1_SOLVERS:
        raise ValueError(f"stage1={stage1!r}: expected host64|topk")
    channels = np.asarray(channels)
    b, nrows, ncols = channels.shape
    eps = float(EPS if eps is None else eps)
    cfg = [b, nrows, ncols, n_row_samples, n_col_samples, n_sinkhorn_iter,
           n_eig_vectors, float(hx), float(hy), eps, float(streaming),
           float(factored), float(stage1 == "topk")]
    check_agreement(np.concatenate([cfg, frames_digest(channels)]), mesh,
                    "train_filter_sharded")
    grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
    p, n = grid.n_samples, grid.n_pixels
    mesh.run_info.clear()

    # Stage 1 of every element on each pixel group's first rank (the
    # groups need every element's kept rank); the bucket agreement checks
    # that every data row found the same ranks.
    s1 = [_stage1_once(channels[i], grid, hx, hy, eps, stage1, mesh)
          for i in range(b)]
    ms = np.array([lam.shape[0] for _, lam in s1], np.int64)
    seen = all_gather_world(ms, mesh)
    if not (seen == ms[None]).all():
        raise ValueError(f"the data rows found different kept ranks: {seen}")
    if (ms == 0).any():
        raise ValueError("Affinity matrix Ka has no eigenvalues above eps.")
    for m in ms:
        warn_truncation(p, int(m), eps)
    mbs = np.array([bucket_m(int(m), p) for m in ms])
    k_out = min(n_eig_vectors, int(ms.min()))
    if k_out < n_eig_vectors and not factored:
        logger.warning(
            "Sharded batch: element with kept rank %d limits every "
            "element's eigenvector count to %d (requested %d).",
            int(ms.min()), k_out, n_eig_vectors)

    n_data, row = mesh.n_data, mesh.data_index
    mine: dict = {}
    src_row: dict = {}
    for mb in np.unique(mbs):
        idx = np.nonzero(mbs == mb)[0]
        short = (-len(idx)) % n_data
        if short:
            idx = np.concatenate([idx, np.repeat(idx[-1:], short)])
        chunk = len(idx) // n_data
        for d in range(n_data):
            for i in idx[d * chunk:(d + 1) * chunk]:
                src_row.setdefault(int(i), d)
        for i in idx[row * chunk:(row + 1) * chunk]:
            i = int(i)
            if i in mine:
                continue     # a padding repeat this row trained already
            Um64, lam64 = s1[i]
            m = int(ms[i])
            mine[i] = train_element(
                channels[i], grid, Um64, lam64, m=m, mb=int(mb),
                k_chain=min(n_eig_vectors, m), k_out=k_out, hx=hx, hy=hy,
                n_iter=n_sinkhorn_iter, eps=eps, streaming=streaming,
                factored=factored, mesh=mesh, index=i)

    dev = mesh.device
    if factored:
        from nle_tpu_torch.models.factored import FactoredFilter

        filters = []
        for i in range(b):
            f = mine.get(i) if src_row[i] == row else None
            if n_data > 1:
                # One fp32 broadcast a filter: [v_head; w; c; eigvals], the
                # float64 (p, k) pieces carried bit for bit as fp32 pairs.
                k = min(n_eig_vectors, int(ms[i]))
                f32, f64 = torch.float32, torch.float64
                pk = 2 * p * k          # fp32 words of the two pieces
                buf = (torch.cat([
                    torch.cat([f.v_head.reshape(-1), f.w.reshape(-1)]).to(
                        f64).view(f32), f.c.to(f32), f.eigvals.to(f32)])
                       if f is not None else
                       torch.empty(2 * pk + n + k, device=dev))
                _bcast_data(buf, src_row[i], mesh)
                if f is None:
                    pieces = buf[:2 * pk].view(f64)
                    f = FactoredFilter(
                        y_train=pack_channel(channels[i], grid.perm)[0],
                        c=buf[2 * pk:2 * pk + n],
                        v_head=pieces[:p * k].view(p, k),
                        w=pieces[p * k:].view(p, k),
                        eigvals=buf[2 * pk + n:], nrows=nrows,
                        ncols=ncols, hx=float(hx), hy=float(hy),
                        perm=grid.perm)
            filters.append(f)
        return filters
    V_out = torch.empty((b, n, k_out), dtype=torch.float32, device=dev)
    S_out = torch.empty((b, k_out), dtype=torch.float32, device=dev)
    for i in range(b):
        if src_row[i] == row:
            V_out[i], S_out[i] = mine[i]
        _bcast_data(V_out[i], src_row[i], mesh)
        _bcast_data(S_out[i], src_row[i], mesh)
    return V_out, S_out


# -- the applies ------------------------------------------------------------------

def apply_filter_sharded(eigvecs, f_eigvals, channel, mesh: RankMesh):
    """V diag(f(S)) V^T c with V's rows and c split over the pixel group:
    proj = all_reduce(V_l^T c_l), out_l = V_l (f(S) proj), the rows
    gathered. Returns the filtered channel (channel's shape) on the rank's
    device."""
    dev = mesh.device
    V = torch.as_tensor(eigvecs, device=dev)
    n, _ = V.shape
    local = -(-n // mesh.n_pixel)
    lo = min(mesh.pixel_index * local, n)
    hi = min(lo + local, n)
    shape = tuple(np.shape(channel))
    c = torch.as_tensor(channel).reshape(-1).to(dev, V.dtype)
    fs = torch.as_tensor(f_eigvals).to(dev, V.dtype)
    V_l = V[lo:hi]
    proj = _psum(V_l.T @ c[lo:hi], mesh)
    out_l = torch.nn.functional.pad(V_l @ (fs * proj), (0, local - (hi - lo)))
    return _gather_rows(out_l, mesh)[:n].reshape(shape)


def apply_filter_factored_sharded(flt, channel, transformed_eigvals,
                                  mesh: RankMesh) -> np.ndarray:
    """The V-free factored apply with the rest rows split over the pixel
    group (models/factored.py's algebra): K10 on the rank's rows gives its
    share of the projection W^T K^T (c y), one k-sized all_reduce, then K11
    on the rank's rows gives its tail rows c (K b), b = W (f(S) proj).
    channel: pixel-order (H, W) host array; returns the filtered channel
    (host, pixel order). The rank's operands (features and c rows) are
    cached on the filter per mesh (`_dev_sharded`), rebuilt when the mesh
    changes."""
    channel_np = np.asarray(channel)
    if channel_np.size != flt.n_pixels:
        raise ValueError(
            "Number of values in channel must match that of training image.")
    p = flt.v_head.shape[0]
    n = flt.n_pixels
    nb = n - p
    nb_local, lo, hi = rest_rows(nb, mesh)
    dev = mesh.device
    state = flt._dev_sharded
    if state is None or state[0] is not mesh:
        flt._dev_sharded = None
        perm = flt.perm
        yt = np.asarray(flt.y_train, np.float32)
        rows = np.concatenate([perm[:p], perm[p + lo:p + hi]])
        feats = np.stack([(rows // flt.ncols).astype(np.float32),
                          (rows % flt.ncols).astype(np.float32),
                          np.concatenate([yt[:p], yt[p + lo:p + hi]])],
                         axis=-1)
        f = upload(feats, dev)
        fa_rows, fb_cols, _ = pad_stream_operands(f[:p], f[p:])
        del f
        c_row = torch.nn.functional.pad(
            flt.c[p + lo:p + hi].to(dev), (0, fb_cols.shape[1] - (hi - lo)))
        flt._dev_sharded = (mesh, fa_rows, fb_cols, c_row[None])
    _, fa_rows, fb_cols, c_row = flt._dev_sharded
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    sw, pw = bandwidth_weights(flt.hx, flt.hy)
    y = channel_np.reshape(-1).astype(np.float32)[flt.perm]
    y_rest = torch.nn.functional.pad(upload(y[p + lo:p + hi], dev),
                                     (0, qpad - (hi - lo)))
    f64 = torch.float64
    ap = streaming_ap(fa_rows, fb_cols, c_row * y_rest[None], sw, pw)
    w = flt.w.to(dev, f64)
    proj_rest = _psum((ap[:, :p].to(f64) @ w)[0], mesh)
    fS = torch.as_tensor(transformed_eigvals).to(dev, f64)
    v_head = flt.v_head.to(dev, f64)
    proj = upload(y[:p], dev).to(f64) @ v_head + proj_rest
    t = fS * proj
    out_head = (v_head @ t).to(torch.float32)
    b = torch.nn.functional.pad(w @ t, (0, ppad - p))
    tail = streaming_atb(fa_rows, fb_cols, b[None].contiguous(), sw, pw)
    out_l = torch.nn.functional.pad((c_row * tail)[0, :hi - lo],
                                    (0, nb_local - (hi - lo)))
    out_rest = _gather_rows(out_l, mesh)[:nb]
    out = torch.cat([out_head, out_rest]).cpu().numpy()
    unpacked = np.empty_like(out)
    unpacked[flt.perm] = out
    return unpacked.reshape(channel_np.shape)
