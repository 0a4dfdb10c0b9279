"""Multi-worker serving: a front-end router over a pool of HTTP edit
service worker processes (port of nle_tpu/serving/pool.py) — the
deployment shape for a multi-card host (one worker per card; each worker
process owns one device).

No reference counterpart (the reference is one process, one training per
run); this extends nle_tpu_torch/serving/http.py the same way a production
fleet fronts single-device model servers:

- STATELESS one-shots (/enhance, /denoise) round-robin across workers —
  every worker can serve any image.
- NAMED-FILTER traffic (/train, /apply, DELETE /filters) routes by
  consistent name hash, so a filter is trained, kept, spilled, and
  applied on the SAME worker (filters are device state; moving them
  means a checkpoint round trip). The hash is the JAX package's, so both
  pools send a name to the same worker index.
- /healthz and /metrics aggregate across workers (per-worker blobs kept
  under "workers").

The pool supervises its workers: spawn, readiness-poll, restart on crash
(named filters on the restarted worker recover via its --spill-dir warm
restart), SIGTERM fan-out on shutdown. Workers run `python -m
nle_tpu_torch.serving.http` in the pool's working directory with the
pool's --device. Device pinning is the env mechanism via --worker-env
(values may contain `{i}`, the worker index):
`--worker-env=CUDA_VISIBLE_DEVICES={i}` gives each worker its own card;
`--worker-env=CUDA_VISIBLE_DEVICES=0` puts every worker on card 0 (each
with its own CUDA context). Every worker also gets NLE_POOL_WORKER_INDEX.
A worker's /healthz answers before any kernel is built (the library
builds at the first request that needs it, under a file lock that
serializes workers sharing a checkout).

Run:

    python -m nle_tpu_torch.serving.pool --workers=2 [--port=8806]
        [--device=cuda|cpu] [--spill-root=DIR] [--token=SECRET]
        [--max-bytes=N] [--worker-env=KEY=VALUE]
"""

from __future__ import annotations

import http.client
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from nle_tpu_torch.serving.http import DEFAULT_MAX_BYTES

_HOP_HEADERS = {"connection", "keep-alive", "transfer-encoding",
                "content-length", "host"}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Worker:
    """One supervised HTTP edit service subprocess."""

    def __init__(self, idx: int, port: int, argv_extra: list,
                 spill_dir: str | None, env_extra: dict | None = None):
        self.idx = idx
        self.port = port
        self.argv_extra = list(argv_extra)
        self.spill_dir = spill_dir
        self.env_extra = dict(env_extra or {})
        self.proc: subprocess.Popen | None = None
        self.restarts = 0
        # Set by the supervisor once a restarted process answers /healthz.
        self.restarted = threading.Event()

    def build_argv(self) -> list:
        """The exact worker command line spawn() executes — factored out
        so tests assert against the real assembly (a regression dropping
        argv_extra or the spill flag fails the test, not just prod)."""
        argv = [sys.executable, "-m", "nle_tpu_torch.serving.http",
                f"--port={self.port}"] + self.argv_extra
        if self.spill_dir is not None:
            argv.append(f"--spill-dir={self.spill_dir}")
        return argv

    def spawn(self) -> None:
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
        # Workers inherit stdout/stderr (operator logs) and the working
        # directory. Per-worker device pinning happens through env_extra
        # (--worker-env, e.g. CUDA_VISIBLE_DEVICES={i} on a multi-card
        # host) plus the always-set NLE_POOL_WORKER_INDEX.
        env = dict(os.environ, **self.env_extra,
                   NLE_POOL_WORKER_INDEX=str(self.idx))
        self.proc = subprocess.Popen(self.build_argv(), env=env)

    def wait_ready(self, timeout: float = 120.0) -> None:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.proc is not None and self.proc.poll() is not None:
                raise RuntimeError(
                    f"worker {self.idx} exited rc={self.proc.returncode} "
                    "during startup")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/healthz",
                        timeout=5) as r:
                    if json.loads(r.read()).get("ok"):
                        return
            except Exception:
                time.sleep(0.2)
        raise RuntimeError(f"worker {self.idx} not ready in {timeout}s")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def terminate(self) -> None:
        if self.alive():
            self.proc.terminate()

    def kill_wait(self, grace: float = 30.0) -> None:
        if self.proc is None:
            return
        try:
            self.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)


class WorkerPool:
    """Spawn + supervise N workers; route by endpoint semantics."""

    def __init__(self, n_workers: int, worker_args: list,
                 spill_root: str | None = None,
                 worker_env: dict | None = None,
                 ready_timeout: float | None = None):
        """worker_env: extra env vars per worker; values may contain `{i}`,
        substituted with the worker index — the device-pinning hook for a
        multi-card host (e.g. {"CUDA_VISIBLE_DEVICES": "{i}"} gives each
        worker its own card). Without it, workers inherit the parent env
        unchanged and all use the first visible card, each with its own
        CUDA context.

        ready_timeout: operator override (--ready-timeout) for the warmed
        boot/restart readiness deadlines. Default: the per-spec-scaled
        deadlines below — a warmed worker runs each --warmup spec before
        binding its port, the first one building the kernel library, so
        worker 0 gets 1800 s PER SPEC and the later boots (library built)
        600 s per spec."""
        self._lock = threading.Lock()
        self._rr = 0
        self.workers = []
        for i in range(n_workers):
            spill = (os.path.join(spill_root, f"worker-{i}")
                     if spill_root else None)
            env_i = {k: v.format(i=i) for k, v in (worker_env or {}).items()}
            self.workers.append(
                _Worker(i, _free_port(), worker_args, spill, env_i))
        self._stop = threading.Event()
        self._monitor: threading.Thread | None = None
        n_specs = sum(1 for a in worker_args if a.startswith("--warmup="))
        self._warmup = n_specs > 0
        # Per-spec-scaled deadlines, overridable by --ready-timeout. The
        # override applies to EVERY readiness wait — plain (non-warmup)
        # boots and supervisor restarts included (review r5: it was
        # silently ignored for those while the usage string advertised it
        # unconditionally).
        self._cold_deadline = (ready_timeout if ready_timeout is not None
                               else 1800.0 * max(1, n_specs))
        self._warm_deadline = (ready_timeout if ready_timeout is not None
                               else 600.0 * max(1, n_specs))
        self._plain_deadline = (ready_timeout if ready_timeout is not None
                                else 120.0)

    def start(self) -> None:
        if self._warmup:
            # Warmed workers run their specs BEFORE binding their port,
            # and the first one builds the kernel library. Boot SERIALLY:
            # worker 0 pays the build under a generous deadline, the rest
            # then load the built library. Spawning all at once would run
            # N warmups at once, on one card where workers share it.
            for i, w in enumerate(self.workers):
                w.spawn()
                w.wait_ready(timeout=self._cold_deadline if i == 0
                             else self._warm_deadline)
        else:
            for w in self.workers:
                w.spawn()
            for w in self.workers:
                w.wait_ready(timeout=self._plain_deadline)
        self._monitor = threading.Thread(target=self._supervise,
                                         daemon=True)
        self._monitor.start()

    def _supervise(self) -> None:
        """Restart crashed workers. A worker with a --spill-dir recovers
        its spilled/checkpointed filters on restart (warm restart);
        resident-only state of a CRASHED (not gracefully stopped) worker
        is lost, exactly like a single-server crash."""
        while not self._stop.is_set():
            for w in self.workers:
                if self._stop.is_set():
                    return
                if w.proc is not None and not w.alive():
                    w.restarts += 1
                    w.spawn()
                    try:
                        # A warmed worker reruns its specs before binding,
                        # which can exceed the plain 120 s deadline.
                        w.wait_ready(timeout=self._warm_deadline
                                     if self._warmup
                                     else self._plain_deadline)
                        w.restarted.set()
                    except RuntimeError:
                        pass   # retried on the next sweep
            self._stop.wait(1.0)

    def stop(self) -> None:
        self._stop.set()
        for w in self.workers:
            w.terminate()
        for w in self.workers:
            w.kill_wait()

    # -- routing ----------------------------------------------------------

    def pick(self, path: str, query: str) -> _Worker:
        if path in ("/train", "/apply", "/filters"):
            # Sticky: a named filter lives on one worker (device state).
            import hashlib

            name = parse_qs(query).get("name", ["default"])[0]
            h = int.from_bytes(
                hashlib.sha1(name.encode()).digest()[:8], "big")
            return self.workers[h % len(self.workers)]
        with self._lock:
            self._rr += 1
            start = self._rr
        # Round-robin, skipping dead workers (mid-restart).
        for off in range(len(self.workers)):
            w = self.workers[(start + off) % len(self.workers)]
            if w.alive():
                return w
        return self.workers[start % len(self.workers)]


def make_pool_server(pool: WorkerPool, port: int = 0,
                     max_bytes: int = DEFAULT_MAX_BYTES,
                     ) -> ThreadingHTTPServer:
    """max_bytes bounds what the front door will BUFFER per request (the
    whole body is read before forwarding): it defaults to the worker's own
    64 MiB limit — an uncapped default would let one oversized POST OOM
    the router."""
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code, body, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _forward(self, method: str, body: bytes | None):
            u = urlparse(self.path)
            w = pool.pick(u.path, u.query)
            conn = http.client.HTTPConnection("127.0.0.1", w.port,
                                              timeout=600)
            try:
                headers = {k: v for k, v in self.headers.items()
                           if k.lower() not in _HOP_HEADERS}
                conn.request(method, self.path, body=body, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                ctype = resp.getheader("Content-Type",
                                       "application/octet-stream")
                self._reply(resp.status, data, ctype)
            except (OSError, http.client.HTTPException) as e:
                self._reply(502, json.dumps(
                    {"error": f"worker {w.idx} unreachable: "
                              f"{type(e).__name__}: {e}"}).encode())
            finally:
                conn.close()

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                views = []
                for w in pool.workers:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{w.port}/healthz",
                                timeout=10) as r:
                            views.append(json.loads(r.read()))
                    except Exception:
                        views.append({"ok": False})
                body = json.dumps({
                    "ok": all(v.get("ok") for v in views),
                    "workers": len(views),
                    "filters": sorted(
                        n for v in views for n in v.get("filters", [])),
                }).encode()
                return self._reply(200, body)
            if path == "/metrics":
                blobs = []
                for w in pool.workers:
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{w.port}/metrics",
                                timeout=10) as r:
                            blobs.append(json.loads(r.read()))
                    except Exception:
                        blobs.append(None)
                tot = {k: sum(b[k] for b in blobs if b)
                       for k in ("trains", "edits", "errors", "rejected")}
                tot["resident_bytes"] = sum(
                    b["filters"]["resident_bytes"] for b in blobs if b)
                tot["restarts"] = sum(w.restarts for w in pool.workers)
                tot["workers"] = [
                    b if b is not None else {"error": "unreachable"}
                    for b in blobs]
                return self._reply(200, json.dumps(tot).encode())
            return self._forward("GET", None)

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                return self._reply(400, json.dumps(
                    {"error": "bad Content-Length header"}).encode())
            if n > max_bytes:
                # Reject at the front door; do not stream a huge body
                # toward a worker that will refuse it anyway. Drain a
                # bounded amount first so a mid-upload client sees the 413
                # instead of a connection reset (same politeness rule as
                # the worker, serving/http.py _drain_body).
                remaining = min(n, 8 << 20)
                while remaining > 0:
                    chunk = self.rfile.read(min(remaining, 1 << 16))
                    if not chunk:
                        break
                    remaining -= len(chunk)
                self.close_connection = True
                return self._reply(413, json.dumps(
                    {"error": f"request body {n} bytes exceeds limit "
                              f"{max_bytes}"}).encode())
            body = self.rfile.read(n)
            self._forward("POST", body)

        def do_DELETE(self):
            # DELETE bodies are never used downstream; read them only to
            # keep the connection in sync, and refuse outsized ones rather
            # than buffering them (same bound as the rejected-POST drain).
            # A malformed Content-Length must close the connection, not be
            # treated as 0 — unread body bytes would desync the next
            # keep-alive request (same rule as the worker's do_DELETE).
            try:
                n = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                n = -1
            if n < 0:
                self.close_connection = True
                return self._reply(400, json.dumps(
                    {"error": "bad Content-Length header"}).encode())
            if n > (8 << 20):
                self.close_connection = True
                return self._reply(413, json.dumps(
                    {"error": f"DELETE body {n} bytes refused"}).encode())
            body = self.rfile.read(n) if n > 0 else None
            self._forward("DELETE", body)

    srv = ThreadingHTTPServer(("127.0.0.1", port), Handler)
    srv.pool = pool
    return srv


def main() -> int:
    n_workers = 2
    port = 8806
    worker_args = []
    spill_root = None
    max_bytes = DEFAULT_MAX_BYTES
    worker_env: dict = {}
    ready_timeout = None
    device = "cuda"
    for a in sys.argv[1:]:
        if a.startswith("--workers="):
            n_workers = int(a.split("=", 1)[1])
        elif a.startswith("--ready-timeout="):
            # Operator override for the warmed boot/restart readiness
            # deadlines (default scales 1800 s / 600 s per --warmup spec).
            try:
                ready_timeout = float(a.split("=", 1)[1])
                if not ready_timeout > 0:   # rejects NaN too
                    raise ValueError
            except ValueError:
                print(f"nle-serve-pool: --ready-timeout needs a positive "
                      f"number of seconds, got {a.split('=', 1)[1]!r}",
                      file=sys.stderr)
                return 2
        elif a.startswith("--port="):
            port = int(a.split("=", 1)[1])
        elif a.startswith("--spill-root="):
            spill_root = a.split("=", 1)[1]
        elif a.startswith("--max-bytes="):
            max_bytes = int(a.split("=", 1)[1])
            worker_args.append(a)
        elif a.startswith("--worker-env="):
            # KEY=VALUE with optional {i} worker-index substitution, e.g.
            # --worker-env=CUDA_VISIBLE_DEVICES={i} pins one card per
            # worker on a multi-card host. Repeatable.
            kv = a.split("=", 1)[1]
            if "=" not in kv:
                print(f"nle-serve-pool: --worker-env needs KEY=VALUE, "
                      f"got {kv!r}", file=sys.stderr)
                return 2
            k, v = kv.split("=", 1)
            worker_env[k] = v
        elif a.startswith("--warmup="):
            # Forwarded to EVERY worker (validated here first: a typo'd
            # spec must fail the pool boot, not each worker process):
            # workers run the expected shapes before binding their ports,
            # so the router's first proxied request is warm
            # (serving/http.py run_warmup; WorkerPool.start boots warmed
            # workers serially, so only worker 0 builds the kernels).
            from nle_tpu_torch.serving.http import parse_warmup_spec

            try:
                parse_warmup_spec(a.split("=", 1)[1])
            except ValueError as e:
                print(f"nle-serve-pool: {e}", file=sys.stderr)
                return 2
            worker_args.append(a)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            if device not in ("cuda", "cpu"):
                print(f"nle-serve-pool: --device={device} invalid "
                      "(expected cuda|cpu)", file=sys.stderr)
                return 2
        elif a.startswith(("--token=", "--max-filters=",
                           "--max-filter-bytes=", "--access-log=",
                           "--reuse-delta=")):
            worker_args.append(a)
        else:
            print(f"nle-serve-pool: unknown argument {a!r}\n"
                  "usage: python -m nle_tpu_torch.serving.pool [--workers=N] "
                  "[--port=N] [--spill-root=DIR] [--device=cuda|cpu] "
                  "[--token=SECRET] "
                  "[--max-bytes=N] [--max-filters=N] [--max-filter-bytes=N] "
                  "[--warmup=H,W,nr,nc[,iters[,k]]] "
                  "[--ready-timeout=SECONDS] [--reuse-delta=D] "
                  "[--worker-env=KEY=VALUE] [--access-log=PATH|-]",
                  file=sys.stderr)
            return 2
    # Every worker runs on the pool's device; without a card,
    # --device=cuda (the default) fails each worker's start.
    worker_args.append(f"--device={device}")
    pool = WorkerPool(n_workers, worker_args, spill_root=spill_root,
                      worker_env=worker_env, ready_timeout=ready_timeout)
    try:
        pool.start()
    except BaseException:
        pool.stop()   # no worker outlives a failed boot
        raise
    srv = make_pool_server(pool, port, max_bytes=max_bytes)
    print(f"nle-tpu serving pool on http://127.0.0.1:{port} "
          f"({n_workers} {device} workers: "
          f"{', '.join(str(w.port) for w in pool.workers)})", flush=True)
    import signal

    def _sigterm(*_):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _sigterm)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        pool.stop()   # workers checkpoint via their own SIGTERM handling
    return 0


if __name__ == "__main__":
    sys.exit(main())
