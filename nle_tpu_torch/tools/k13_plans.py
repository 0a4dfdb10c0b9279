"""K13, the striped f32 half-step of NLE_SINKHORN_KERNEL=auto, at
chip_smoke.py's two K13 shapes on one NVIDIA GPU: the time of its plan
(sinkhorn_kernel.k13_plan) beside other plans of the same kernel, its
second pass alone, and K13's earlier sweep (K17's parts3d launch of it,
with its one-stripe reduce), K4 and torch.mv on the same factor; every
plan's (x, s) must be bit for bit the earlier sweep's.

    python3 -m nle_tpu_torch.tools.k13_plans

The shapes: the 1 MP assembled factor (npad 1,011,712, mpad 640, tile
1024) and 2^20 rows at mpad 2176 (tile 512). The factor is normal x 0.05
+ 0.1, t uniform, made on the card from seed 0 (the times do not depend
on the values). Each other plan changes one of k13_plan's choices: rows
a sub-tile (R), slots of the ring (S) or tiles a CTA; the C entry takes
any plan that covers every tile once in whole sub-tiles, so the order of
every sum, and with it the bits, stays the same. The second pass (the
8-stripe ordered reduce of the per-tile partials) is read from a
torch.profiler trace of K13 calls. Prints the card's name and power limit,
then one JSON line a shape. Needs an NVIDIA GPU (returns 2 without one).
Imports no JAX.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SHAPES = {"1mp": (1_011_712, 640, 1024), "mpad2176": (1 << 20, 2176, 512)}
# Plans beside k13_plan's, as (rows, slots, tiles a CTA); None keeps the
# plan's value.
OTHER_PLANS = {
    "1mp": ((8, 4, None), (4, 8, None), (16, 2, 8), (8, 2, None),
            (32, 2, None)),
    "mpad2176": ((2, 5, None), (1, 11, None), (4, 3, None), (4, 2, 16),
                 (8, 2, None)),
}
EPS = 1e-10


def other_plan(plan, npad: int, mpad: int, tile: int, rows, slots, per_cta):
    """k13_plan's plan with rows, slots or tiles a CTA replaced."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import K13Plan, SK_MAX_ROWS

    rows = rows or plan.rows
    slots = slots or plan.slots
    per_cta = per_cta or plan.per_cta
    ntiles = npad // tile
    shared = 128 + slots * rows * 4 * mpad + 4 * (mpad + 2 * SK_MAX_ROWS)
    return K13Plan(rows, slots, -(-ntiles // per_cta), per_cta, shared)


def launch(torch, phi, t, tile: int, plan):
    """K13's C entry on `plan` (not counted: a tool's reading)."""
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import launch_sweep

    npad, mpad = phi.shape
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=phi.device)
    partial = torch.empty((npad // tile, mpad), dtype=torch.float32,
                          device=phi.device)
    _build.check(launch_sweep(_build.load().nle_sinkhorn_tiled_f32, phi, t, x,
                              partial, s, npad, mpad, tile, *plan, EPS),
                 f"K13 on {tuple(plan)}")
    return x, s


def second_pass_ms(torch, fn, calls: int = 5) -> dict:
    """Device ms a call of each kernel fn launches, from a profiled run of
    `calls` calls: {kernel name: ms}; empty when the profiler saw no
    device events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            out[e.key] = us / 1e3 / calls
    return out


def measure(torch, cs, tag: str, reps: int = 10) -> dict:
    from nle_tpu_torch.ops.kernels.sinkhorn_ab_kernel import sinkhorn_variant
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        k13_plan,
        sinkhorn_halfstep,
        sinkhorn_halfstep_tiled,
    )
    from nle_tpu_torch.tools._sk_bench import make_factor

    npad, mpad, tile = SHAPES[tag]
    phi, t = make_factor(torch, npad, mpad, 0, 0.1)
    plan = k13_plan(npad, mpad, tile)
    old = cs.k13_by_old_sweep(torch, phi, t, EPS, tile)
    rec = {"shape": tag, "npad": npad, "mpad": mpad, "tile": tile,
           "plan": list(plan),
           "bound_ms": cs.bound_ms(4 * (npad * mpad + npad + 2 * mpad),
                                   4 * npad * mpad)[0]}
    plans = [("k13_plan", plan)] + [
        (f"R={r or plan.rows} S={s or plan.slots} per_cta={c or plan.per_cta}",
         other_plan(plan, npad, mpad, tile, r, s, c))
        for r, s, c in OTHER_PLANS[tag]]
    rec["plans"] = []
    for label, p in plans:
        got = launch(torch, phi, t, tile, p)
        same = torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
        del got
        ms = cs.cuda_ms(torch, lambda p=p: launch(torch, phi, t, tile, p),
                        reps=reps)
        rec["plans"].append({"plan": label, "rows": p.rows, "slots": p.slots,
                             "ctas": p.ctas, "per_cta": p.per_cta,
                             "shared_bytes": p.shared_bytes, "ms": ms,
                             "bound_share": rec["bound_ms"] / ms,
                             "bitwise_earlier_sweep": same})
    # The earlier sweep with its own one-stripe reduce (K17's parts3d), as
    # k13_by_old_sweep's torch adds would time the host, not the sweep.
    rec["earlier_sweep_ms"] = cs.cuda_ms(
        torch, lambda: sinkhorn_variant(phi, t, EPS, "parts3d", tile),
        reps=reps)
    rec["k4_ms"] = cs.cuda_ms(torch, lambda: sinkhorn_halfstep(phi, t, EPS),
                              reps=reps)
    rec["torch_mv_ms"] = cs.cuda_ms(torch, lambda: torch.mv(phi, t),
                                    reps=reps)
    rec["profile_ms"] = second_pass_ms(
        torch, lambda: sinkhorn_halfstep_tiled(phi, t, EPS, tile))
    del phi, t, old
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k13_plans measures the card: torch.cuda.is_available() is "
              "False", file=sys.stderr)
        return 2
    sys.path.insert(1, ROOT)
    import chip_smoke as cs

    from nle_tpu_torch.tools._sk_bench import card_line

    print(card_line())
    for tag in SHAPES:
        rec = measure(torch, cs, tag)
        rec["card"] = torch.cuda.get_device_name(0)
        print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
