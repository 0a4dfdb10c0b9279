"""Load check of the HTTP serving stack on one device (port of
tools/check_tpu_serving.py).

Starts the edit service in-process (serving/http.py make_server), sends
concurrent /enhance requests over real sockets, and checks that

  - each response is bitwise a direct NLEFilter(device).train_and_enhance
    of its frame (the server path and the library path do not diverge);
  - two byte-identical requests get byte-identical responses (determinism
    through the coalescer under concurrency);
  - the requests coalesced into stream-mode batches (batched_filters >
    train_batches in /metrics).

    python -m nle_tpu_torch.tools.check_serving [--device=cuda|cpu]
        [--shape=HxW] [--n=N]

prints one JSON line (rc 0 = ok). Frames are made with numpy (seed 0): a
structured frame, its byte copy, and exposure-jittered copies; the rock2
parameters (20 30 500 10 50 50, weights 4,3,4,1). The card by default
(832x1216, 1 MP); without one, --device=cuda raises.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PARAMS = (20, 30, 500.0, 10.0, 50, 50)
WEIGHTS = (4.0, 3.0, 4.0, 1.0)
SHAPE = (832, 1216)


def structured_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth, photo-like BGR frame: low-frequency shading, a few soft
    discs and mild texture (chip_smoke.py's frame)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 110 + 50 * np.sin(xx / (w / 5.0)) * np.cos(yy / (h / 3.0))
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(0.05, 0.2) * min(h, w)
        base += rng.uniform(-40, 40) / (1 + np.exp(np.minimum(
            ((yy - cy) ** 2 + (xx - cx) ** 2) ** 0.5 / 8 - rad / 8, 700.0)))
    base += rng.normal(0, 2.0, (h, w))
    img = np.stack([base * 0.9 + 10, base, base * 1.05 - 5], axis=-1)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def frames(base: np.ndarray, n: int, seed: int = 0) -> list:
    """n same-shape frames: the base, its byte copy (the determinism pair),
    then exposure-jittered copies (Lab L shifted by a distinct nonzero
    amount each)."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np

    rng = np.random.default_rng(seed)
    out = [base, base.copy()]
    span = [d for d in range(-2 * n, 2 * n + 1) if d != 0]
    for d in rng.choice(span, size=max(0, n - 2), replace=False):
        lab = bgr_to_lab_u8_np(base)
        lab[..., 0] = np.clip(lab[..., 0].astype(np.int32) + int(d),
                              0, 255).astype(np.uint8)
        out.append(lab_to_bgr_u8_np(lab))
    return out[:n]


def query(params=PARAMS, weights=WEIGHTS) -> str:
    return (f"nr={params[0]}&nc={params[1]}&hx={params[2]:g}"
            f"&hy={params[3]:g}&iters={params[4]}&k={params[5]}"
            f"&w={','.join(f'{x:g}' for x in weights)}")


def run(imgs, device="cuda", params=PARAMS, weights=WEIGHTS) -> dict:
    """The check on `imgs` (imgs[1] a byte copy of imgs[0]); returns the
    result dict, "ok" among its keys."""
    from nle_tpu_torch.models.filter import NLEFilter
    from nle_tpu_torch.serving.http import make_server
    from nle_tpu_torch.utils.imageio import imdecode_bgr, imencode_png

    bodies = [imencode_png(f) for f in imgs]
    srv = make_server(device=device)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    cfg = query(params, weights)

    def post(body):
        req = urllib.request.Request(f"{base}/enhance?{cfg}", data=body)
        with urllib.request.urlopen(req, timeout=1800) as r:
            return r.read()

    try:
        t0 = time.perf_counter()
        post(bodies[-1])
        alone_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(bodies)) as ex:
            outs = list(ex.map(post, bodies))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            m = json.loads(r.read())
    finally:
        srv.shutdown()
    # Library references, trained outside the server so a server-side
    # defect cannot cancel out of the comparison.
    exact = []
    for img, out in zip(imgs, outs):
        want = NLEFilter(device=device).train_and_enhance(
            img, *params, weights=list(weights))
        exact.append(bool(np.array_equal(imdecode_bgr(out), want)))
    deterministic = outs[0] == outs[1]
    coalesced = m["batched_filters"] > m["train_batches"]
    ok = (all(exact) and deterministic and coalesced and m["errors"] == 0
          and m["trains"] == len(imgs) + 1)
    mp = imgs[0].shape[0] * imgs[0].shape[1] / 1e6
    return {
        "ok": bool(ok), "device": str(device), "n": len(imgs),
        "shape": list(imgs[0].shape[:2]),
        "alone_s": alone_s, "concurrent_wall_s": wall,
        "requests_per_s": len(imgs) / wall, "mp_per_s": len(imgs) * mp / wall,
        "exact": exact, "deterministic": bool(deterministic),
        "coalesced": bool(coalesced), "train_batches": m["train_batches"],
        "batched_filters": m["batched_filters"], "errors": m["errors"],
        "peak_device_bytes": max(
            (row["peak_bytes_in_use"]
             for row in m["device_memory"].values()), default=None),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device, shape, n = "cuda", SHAPE, 4
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        elif a.startswith("--shape="):
            shape = tuple(int(x) for x in a.split("=", 1)[1].split("x"))
        elif a.startswith("--n="):
            n = int(a.split("=", 1)[1])
        else:
            print(f"check_serving: unknown argument {a!r}\nusage: python -m "
                  "nle_tpu_torch.tools.check_serving [--device=cuda|cpu] "
                  "[--shape=HxW] [--n=N]", file=sys.stderr)
            return 2
    if n < 3:
        print("check_serving: --n must be >= 3 (a frame, its byte copy and "
              "a jittered frame)", file=sys.stderr)
        return 2
    res = run(frames(structured_frame(*shape), n), device=device)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
