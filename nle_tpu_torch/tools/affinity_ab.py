"""K1's, K12's, the streaming kernels' and K13's outputs and the 1 MP
dense edit from two versions of the port, on one NVIDIA GPU: is a change
to the affinity core (K1, K2's contract, K12's phi step), to the streaming
kernels (K10, K11, K9's two passes) or to K13 (the striped half-step of
NLE_SINKHORN_KERNEL=auto) bit for bit the version it replaces, and how
fast is each?

    python3 nle_tpu_torch/tools/affinity_ab.py --root DIR --out FILE.npz
    python3 nle_tpu_torch/tools/affinity_ab.py --compare A.npz B.npz [...]

--root names the checkout whose nle_tpu_torch package is imported (the
port of this checkout by default; e.g. a `git archive` of an earlier
commit unpacked into a gitignored directory), so one process measures one
version; the frames and operands come from this checkout's chip_smoke.py
(numpy-made, seeds fixed). Per version it writes K1 at chip_smoke's [3]
(the 1 MP main path, p = 600) and [9b] (p = 1200) shapes, with the
out_rows layout the path uses, and K12 (streaming_scaled_gram) at the
[9a] 16 MP and [7] 32 MP capacity shapes (k12_operands: every pixel of
the frame, the shape's samples at random pixels, a random Uinv; made on
the card from seed 0); on the same operands (stream_records) K10
(streaming_ap) and K11 (streaming_atb) at R = 1 and 3, K10's unit_x pass
(the s0 pass of streaming training), factored_apply (K10, then K11, on a
seeded filter) and, on the 16 MP operands' first 2^20 rows with the
samples zero-padded to Ppad 4224, K9's two passes; K13's (x, s) at
chip_smoke's [10a] shape (the 1 MP assembled factor of its main frame,
tile 1024) and [9d]'s width (2^20 rows at mpad 2176, tile 512; a factor
normal x 0.05 + 0.1 made on the card from seed 0): the SHA-256 of each
output and its CUDA-event ms; and the u8 edit of
NLEFilter(device="cuda").train_and_enhance on the 1 MP frame (rock2
parameters), by default and under NLE_SINKHORN_KERNEL=auto (K13 x 100).
--compare prints whether every file holds the same digests and edits as
the first, and each file's times; run the versions in turns (A, B, B, A)
in one call to compare times on one card. Imports no JAX."""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# K12's shapes: (frame h, w, samples, Ppad, Mpad, eigenvectors) of [9a]
# and [7], with their bandwidths (hx 5000, hy 30).
K12_SHAPES = {"16mp": (4000, 4000, 2112, 2176, 384, 320),
              "32mp": (5656, 5656, 600, 640, 384, 321)}
K12_BANDWIDTHS = (1.0 / 5000.0 ** 2, 1.0 / 30.0 ** 2)


def k12_operands(torch, h, w, p, ppad, mpad, m):
    """The streaming operands of an h x w frame: every pixel but the p
    samples as rest rows (grid coordinates, random y), p random samples,
    c = 1 on the rest rows, and a random (p, m) Uinv in an (Ppad, Mpad)
    zero pad; made on the card from seed 0."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = h * w - p
    qpad = -(-q // 512) * 512
    idx = torch.arange(qpad, device=dev)
    fb = torch.stack([(idx // w).float(), (idx % w).float(), torch.randint(
        0, 100, (qpad,), device=dev, generator=g).float()])
    fb[:, q:] = 0.0
    sel = torch.randint(0, h * w, (p,), device=dev, generator=g)
    fa = torch.zeros((3, ppad), device=dev)
    fa[:, :p] = torch.stack([(sel // w).float(), (sel % w).float(),
                             torch.randint(0, 100, (p,), device=dev,
                                           generator=g).float()])
    c = (idx < q).float()[None].contiguous()
    uinv = torch.zeros((ppad, mpad), device=dev)
    uinv[:p, :m] = torch.randn((p, m), device=dev, generator=g)
    return fa, fb, c, uinv


# The two-pass K9's shape: the 16 MP operands' first rows against the
# samples zero-padded past the one-build kernel's Ppad 4096.
TWO_PASS_ROWS = 1 << 20
TWO_PASS_PPAD = 4224


def stream_records(torch, cs, rec: dict) -> None:
    """The streaming kernels on k12_operands at each K12_SHAPES shape, into
    rec: {name}_sha256 and {name}_ms for K10 and K11 at R = 1 and 3 (x
    rows and b rows made on the card from seed 1, zero on pad rows and
    samples), the unit_x pass, factored_apply on a seeded filter of k = 50
    and, at 16 MP, K9's two passes."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        streaming_ap,
        streaming_atb,
        streaming_halfstep,
        streaming_halfstep_ptiled,
    )
    from nle_tpu_torch.ops.pipeline import factored_apply

    sw, pw = K12_BANDWIDTHS
    eps = 1e-10
    pad = torch.nn.functional.pad

    def put(name, fn):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for t in got:
            h.update(t.cpu().numpy().tobytes())
        rec[f"{name}_sha256"] = h.hexdigest()
        del got
        rec[f"{name}_ms"] = cs.cuda_ms(torch, fn)

    for tag, (h, w, p, ppad, mpad, m) in K12_SHAPES.items():
        fa, fb, c, _ = k12_operands(torch, h, w, p, ppad, mpad, m)
        g = torch.Generator(device="cuda").manual_seed(1)
        X = torch.rand((3, fb.shape[1]), device="cuda", generator=g) * c
        B = torch.zeros((3, ppad), device="cuda")
        B[:, :p] = torch.randn((3, p), device="cuda", generator=g) * 1e-3
        for R in (1, 3):
            put(f"k10_r{R}_{tag}", lambda: streaming_ap(
                fa, fb, X[:R].contiguous(), sw, pw))
            put(f"k11_r{R}_{tag}", lambda: streaming_atb(
                fa, fb, B[:R].contiguous(), sw, pw))
        put(f"unit_x_{tag}", lambda: streaming_halfstep(
            fa, fb, c, fa.new_zeros(ppad), sw, pw, eps, unit_x=True)[1])
        # A factored filter on this frame: the samples first, then the
        # rest pixels (fb's rows), k = 50 eigenvectors.
        q, k = h * w - p, 50
        feat = torch.cat([fa[:, :p], fb[:, :q]], dim=1)
        v_head = torch.randn((p, k), device="cuda", generator=g) * 1e-2
        w_tail = torch.randn((p, k), device="cuda", generator=g) * 1e-3
        f_eig = torch.rand(k, device="cuda", generator=g)
        c_all = torch.rand(h * w, device="cuda", generator=g)
        put(f"factored_apply_{tag}", lambda: factored_apply(
            feat[2], feat[2], feat[0], feat[1], c_all, v_head, w_tail, f_eig,
            sw, pw, p=p))
        if tag == "16mp":
            fa2 = pad(fa, (0, TWO_PASS_PPAD - ppad)).contiguous()
            fb2 = fb[:, :TWO_PASS_ROWS].contiguous()
            mask2 = c[:, :TWO_PASS_ROWS].contiguous()
            u2 = pad(B[0], (0, TWO_PASS_PPAD - ppad)).contiguous()
            put("k9_two_pass", lambda: streaming_halfstep_ptiled(
                fa2, fb2, mask2, u2, sw, pw, eps))
            del fa2, fb2, mask2, u2
        del fa, fb, c, X, B, feat, v_head, w_tail, f_eig, c_all
        torch.cuda.empty_cache()


# K13's row tile at chip_smoke's [10a] shape (the 1 MP assembled factor)
# and at [9d]'s width (K13_WIDE, a seeded factor).
K13_TILES = {"1mp": 1024, "mpad2176": 512}
K13_WIDE = (1 << 20, 2176)


def k13_records(torch, cs, L, rec: dict) -> None:
    """K13 on each K13_TILES factor into rec: k13_{tag}_sha256 of (x, s)
    and k13_{tag}_ms."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        sinkhorn_halfstep_tiled,
    )

    dev = torch.device("cuda")
    for tag, tile in K13_TILES.items():
        if tag == "1mp":
            phi, t, _, _ = cs.assembled_factor(torch, L, dev)
        else:
            g = torch.Generator(device=dev).manual_seed(0)
            phi = torch.randn(K13_WIDE, generator=g, device=dev) * 0.05
            phi += 0.1
            t = torch.rand((K13_WIDE[1],), generator=g, device=dev)

        def k13():
            return sinkhorn_halfstep_tiled(phi, t, 1e-10, tile)

        x, s = k13()
        torch.cuda.synchronize()
        h = hashlib.sha256(x.cpu().numpy().tobytes())
        h.update(s.cpu().numpy().tobytes())
        rec[f"k13_{tag}_sha256"] = h.hexdigest()
        del x, s
        rec[f"k13_{tag}_ms"] = cs.cuda_ms(torch, k13, reps=10)
        del phi, t
        torch.cuda.empty_cache()


def dump(out: str) -> None:
    import torch

    # This checkout's chip_smoke.py by its path: --root's checkout, first
    # on sys.path, holds a chip_smoke of its own.
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
    )
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import split_row_pad

    if not torch.cuda.is_available():
        raise RuntimeError("affinity_ab measures the card: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    img = cs.structured_frame(*cs.MAIN_SHAPE)
    L = bgr_to_lab_u8_np(img)[..., 0].astype(np.float32)
    rec = {}
    for tag, args in (("p600", cs.MAIN_ARGS), ("p1200", cs.P1200_ARGS)):
        op = cs.path_operands(torch, L, args, dev)
        rows = split_row_pad(op.n - op.p)

        def k1():
            return affinity_matmul_kernel(op.fa, op.fb, op.Uinv, op.sw,
                                          op.pw, out_rows=rows)

        got = k1()
        torch.cuda.synchronize()
        rec[f"k1_{tag}_sha256"] = hashlib.sha256(
            got.cpu().numpy().tobytes()).hexdigest()
        rec[f"k1_{tag}_shape"] = list(got.shape)
        del got
        rec[f"k1_{tag}_ms"] = cs.cuda_ms(torch, k1)
        del op
        torch.cuda.empty_cache()
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        streaming_scaled_gram,
    )

    for tag, shape in K12_SHAPES.items():
        fa, fb, c, uinv = k12_operands(torch, *shape)

        def k12():
            return streaming_scaled_gram(fa, fb, c, uinv, *K12_BANDWIDTHS)

        rec[f"k12_{tag}_sha256"] = hashlib.sha256(
            k12().cpu().numpy().tobytes()).hexdigest()
        rec[f"k12_{tag}_ms"] = cs.cuda_ms(torch, k12)
        del fa, fb, c, uinv
        torch.cuda.empty_cache()
    stream_records(torch, cs, rec)
    k13_records(torch, cs, L, rec)
    edit = NLEFilter(device="cuda").train_and_enhance(img, *cs.MAIN_ARGS,
                                                      weights=cs.WEIGHTS)
    with cs.knobs(NLE_SINKHORN_KERNEL="auto"):
        edit_auto = NLEFilter(device="cuda").train_and_enhance(
            img, *cs.MAIN_ARGS, weights=cs.WEIGHTS)
    import nle_tpu_torch

    rec["package"] = os.path.dirname(os.path.abspath(nle_tpu_torch.__file__))
    rec["card"] = torch.cuda.get_device_name(0)
    np.savez(out, edit=edit, edit_auto=edit_auto, meta=json.dumps(rec))
    print(json.dumps(rec))


def compare(paths) -> int:
    first = None
    same = True
    for path in paths:
        with np.load(path) as f:
            edits, rec = (f["edit"], f["edit_auto"]), json.loads(
                str(f["meta"]))
        if first is None:
            first = (edits, rec)
        digests = all(rec[k] == first[1][k] for k in rec
                      if k.endswith(("sha256", "shape")))
        equal = [np.array_equal(a, b) for a, b in zip(edits, first[0])]
        same &= digests and all(equal)
        stream = ", ".join(f"{k[:-3]} {v:.3f}" for k, v in rec.items()
                           if k.endswith("_ms") and not k.startswith(
                               ("k1_", "k12_")))
        print(f"{path}: {rec['package']}; ms K1 p600 {rec['k1_p600_ms']:.3f}"
              f", p1200 {rec['k1_p1200_ms']:.3f}, K12 16 MP "
              f"{rec['k12_16mp_ms']:.3f}, 32 MP {rec['k12_32mp_ms']:.3f}; "
              f"{stream}; every digest as the first: {digests}; 1 MP u8 "
              f"edit as the first: {equal[0]}; under "
              f"NLE_SINKHORN_KERNEL=auto: {equal[1]}")
    print(json.dumps({"bitwise_equal": bool(same)}))
    return 0 if same else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose nle_tpu_torch is measured")
    ap.add_argument("--out", help="npz to write (dump mode)")
    ap.add_argument("--compare", nargs="+", help="npz files to compare")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(args.compare)
    sys.path.insert(0, os.path.abspath(args.root))
    dump(args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
