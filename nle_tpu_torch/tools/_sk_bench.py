"""What the Sinkhorn staging tools share: the factor made on the card, the
CUDA-event timing, the two yardsticks every table carries (K15 dmaonly at
chunk 1024, the staging floor of the port's half-steps, and torch.mv on
the same factor, a library call the port never makes), the table's
format and the command line.

Each table row: {"kernel", "config", "launch" (its _build.LAUNCHES key,
None for torch.mv), "bytes" (the factor's), "ms" (per sweep: CUDA events
over `sweeps` launches, the least of 3 runs), "gb_s", "x_dmaonly",
"x_mv"}. There is no CPU timing: without a card the table functions raise
RuntimeError and the tools return 2.
"""

from __future__ import annotations

import argparse
import json
import subprocess

N_PIXELS = 1_000_000     # the JAX tools' n
M_COLS = 640             # and m
FLOOR_CHUNK = 1024       # K15 dmaonly's yardstick chunk


def padded(n: int, align: int) -> int:
    return -(-n // align) * align


def require_card(torch, tool: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} measures the card: "
                           "torch.cuda.is_available() is False")


def make_factor(torch, npad: int, mpad: int, seed: int, offset: float):
    """phi (npad, mpad) normal x 0.05 + offset and t (mpad,) uniform,
    made on the card from `seed` (the JAX tools' recipe; the kernels'
    times do not depend on the values)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    phi = torch.randn((npad, mpad), generator=gen, device=dev) * 0.05
    if offset:
        phi += offset
    t = torch.rand((mpad,), generator=gen, device=dev)
    return phi, t


def ms_per_call(torch, fn, sweeps: int, repeats: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(sweeps):
            fn()
        t1.record()
        torch.cuda.synchronize()
        best = min(best, t0.elapsed_time(t1) / sweeps)
    return best


def timed_row(torch, kernel: str, config: str, launch, phi, fn,
              sweeps: int) -> dict:
    nbytes = phi.element_size() * phi.numel()
    ms = ms_per_call(torch, fn, sweeps)
    return dict(kernel=kernel, config=config, launch=launch, bytes=nbytes,
                ms=ms, gb_s=nbytes / ms / 1e6)


def with_yardsticks(torch, rows: list[dict], phi, t, sweeps: int):
    """Append K15 dmaonly (chunk 1024) and torch.mv on the same factor and
    give every row its ratio to both."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import sinkhorn_probe

    floor = timed_row(torch, "K15", f"dmaonly chunk={FLOOR_CHUNK}",
                      "sinkhorn_probe_dmaonly", phi,
                      lambda: sinkhorn_probe(phi, t, "dmaonly", FLOOR_CHUNK),
                      sweeps)
    mv = timed_row(torch, "torch.mv", "phi t (library yardstick)", None,
                   phi, lambda: torch.mv(phi, t), sweeps)
    rows = [*rows, floor, mv]
    for r in rows:
        r["x_dmaonly"] = r["ms"] / floor["ms"]
        r["x_mv"] = r["ms"] / mv["ms"]
    return rows


def format_rows(rows) -> list[str]:
    return [f"{r['kernel']:8s} {r['config']:28s} {r['ms']:8.3f} ms/sweep "
            f"{r['gb_s']:8.1f} GB/s {r['x_dmaonly']:6.3f} x dmaonly "
            f"{r['x_mv']:6.3f} x torch.mv" for r in rows]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def int_list(text: str) -> tuple[int, ...]:
    return tuple(int(v) for v in text.split(","))


def tool_main(argv, tool: str, doc: str, npad: int, sweeps: int, table,
              lists: dict) -> int:
    """The tools' command line: --npad/--mpad/--sweeps/--seed plus the
    comma lists of `lists` ({flag: (default, parse)}); prints the table,
    the card line and one JSON line. Returns 2 without a card."""
    import torch

    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--npad", type=int, default=npad)
    ap.add_argument("--mpad", type=int, default=M_COLS)
    ap.add_argument("--sweeps", type=int, default=sweeps)
    ap.add_argument("--seed", type=int, default=0)
    for flag, (default, parse) in lists.items():
        ap.add_argument(f"--{flag}", type=parse, default=default)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print(f"{tool}: torch.cuda.is_available() is False; this measures "
              "an NVIDIA GPU.")
        return 2
    extra = {flag: getattr(args, flag) for flag in lists}
    rows = table(torch, args.npad, args.mpad, args.sweeps, args.seed,
                 **extra)
    for line in format_rows(rows):
        print(line)
    card = card_line()
    print(card)
    print(json.dumps({"tool": tool, "card": card, "npad": args.npad,
                      "mpad": args.mpad, "sweeps": args.sweeps,
                      "seed": args.seed, "rows": rows}))
    return 0
