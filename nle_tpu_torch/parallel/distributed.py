"""Multi-process training over torch.distributed (port of
nle_tpu/parallel/distributed.py).

The JAX package runs one controller process per host, its local devices
the mesh's "pixel" axis. Here every rank is a process of its own:
`initialize` joins the process group (an init method such as
tcp://HOST:PORT or file://PATH, the world size and the rank, as nothing on
the machine announces a cluster) and binds the rank's device;
`make_global_mesh` lays the ranks out as ("data", "pixel") with
n_pixel ranks a data row (by default LOCAL_WORLD_SIZE, the ranks of one
host, else 1).

Device and backend (nothing switches quietly):
- device="cuda" (the default) binds the rank to card LOCAL_RANK (else
  its rank) modulo device_count;
  backend None means NCCL there and gloo on the CPU. NCCL takes one rank a
  card, so more ranks than cards raises, unless the caller asks for
  backend="gloo", which lets ranks share a card (chip_smoke.py [15]
  measures the sharding code that way on one card: not multi-card
  scaling).
- backend="nccl" on the CPU raises.

`train_filters_multihost`: each data row passes its own frames (every
rank of a row the same ones). The configuration is checked by an
all_gather (a mismatch raises on every rank instead of hanging), the rank
bucket of each step is agreed by an all_gather of m, and each step trains
one frame a row through parallel/sharded.py's train_element.

Worker entry (dryrun_multihost and the tests launch it):

    python -m nle_tpu_torch.parallel.distributed --selfcheck --nproc=N \\
        --pid=I --init=file:///tmp/x [--device=cuda|cpu] \\
        [--backend=nccl|gloo]

`launch` runs such workers and kills all of them when one fails or the
time runs out.
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from nle_tpu_torch.config import resolve_device
from nle_tpu_torch.parallel import sharded

# Seconds a collective may wait for the other ranks before it raises.
DEFAULT_TIMEOUT_S = 300.0


def initialize(init_method: str, world_size: int, rank: int, *,
               device="cuda", backend: str | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """init_process_group for this rank, its device bound first. Returns
    the device. The rank's card is its rank on its host: LOCAL_RANK (as
    torchrun sets it), else the rank (one host). Raises where the request
    cannot run as asked (see the module docstring)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend={backend!r}: expected nccl|gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs device='cuda'")
    kwargs = {}
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= cards and backend != "gloo":
            raise ValueError(
                f"local rank {local} but {cards} card(s): NCCL takes one "
                "rank a card; pass backend='gloo' to let ranks share a card")
        dev = torch.device("cuda", local % cards)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    sharded.set_rank_device(dev)
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
    sharded.set_rank_device(None)


def make_global_mesh(n_pixel: int | None = None) -> sharded.RankMesh:
    """("data", "pixel") over every rank: n_pixel consecutive ranks a data
    row (default LOCAL_WORLD_SIZE, else 1), so the pixel axis stays on a
    host and the data axis crosses hosts."""
    if n_pixel is None:
        n_pixel = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    world = dist.get_world_size()
    if world % n_pixel:
        raise RuntimeError(f"{world} ranks do not split into rows of "
                           f"{n_pixel}")
    return sharded.make_mesh(world // n_pixel, n_pixel)


def train_filters_multihost(channels_local, n_row_samples: int,
                            n_col_samples: int, hx: float, hy: float,
                            n_sinkhorn_iter: int, n_eig_vectors: int,
                            mesh: sharded.RankMesh | None = None, *,
                            eps: float | None = None,
                            streaming: bool = False, factored: bool = False):
    """Train this data row's frames (B_local, H, W), one a step. Every rank
    must pass the same B_local and parameters, and the ranks of one data
    row the same frames; checked by an all_gather, a mismatch raises on
    every rank. Returns [(V (N, k_i) pixel order, S (k_i,)), ...] host
    arrays for the row's frames, k_i = min(n_eig_vectors, the step's least
    kept rank over the rows); factored=True (requires streaming=True)
    V-free FactoredFilters with their own k = min(n_eig_vectors, m)."""
    from nle_tpu_torch.config import EPS
    from nle_tpu_torch.ops.pipeline import bucket_m
    from nle_tpu_torch.ops.sampling import sample_grid
    from nle_tpu_torch.utils.logging import logger, warn_truncation

    if factored and not streaming:
        raise ValueError(
            "factored=True requires streaming=True (same contract as "
            "parallel/sharded.py train_filter_sharded).")
    if mesh is None:
        mesh = make_global_mesh()
    channels_local = np.asarray(channels_local, np.float32)
    b_local, nrows, ncols = channels_local.shape
    eps = float(EPS if eps is None else eps)
    cfg = [b_local, nrows, ncols, n_row_samples, n_col_samples,
           n_sinkhorn_iter, n_eig_vectors, float(hx), float(hy), eps,
           float(bool(streaming)), float(bool(factored))]
    sharded.check_agreement(cfg, mesh, "multihost",
                            group_digest=sharded.frames_digest(
                                channels_local))
    mesh.run_info.clear()
    grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
    p = grid.n_samples
    out = []
    for step_i in range(b_local):
        chan = channels_local[step_i]
        Um64, lam64 = sharded._stage1_once(chan, grid, hx, hy, eps, "host64",
                                           mesh)
        m = lam64.shape[0]
        m_all = sharded.all_gather_world(np.array([m], np.int64),
                                         mesh).ravel()
        if (m_all == 0).any():
            raise ValueError("Affinity matrix Ka has no eigenvalues above "
                             f"eps on some row: kept ranks {m_all}")
        warn_truncation(p, m, eps)
        # The step's bucket: the largest over the rows (smaller ranks pad
        # into it; their columns past m are exact zeros).
        mb = max(bucket_m(int(mi), p) for mi in m_all)
        if factored:
            k_step = min(n_eig_vectors, m)
        else:
            k_step = min(n_eig_vectors, int(m_all.min()))
            if k_step < n_eig_vectors:
                logger.warning(
                    "Multihost step %d: kept rank %d on some row limits "
                    "every row's eigenvector count to %d (requested %d).",
                    step_i, int(m_all.min()), k_step, n_eig_vectors)
        res = sharded.train_element(
            chan, grid, Um64, lam64, m=m, mb=mb, k_chain=k_step,
            k_out=k_step, hx=hx, hy=hy, n_iter=n_sinkhorn_iter, eps=eps,
            streaming=streaming, factored=factored, mesh=mesh, index=step_i)
        if factored:
            out.append(res)
        else:
            out.append((res[0].cpu().numpy(), res[1].cpu().numpy()))
    return out


# -- the localhost self-check and the launcher ---------------------------------

def _assert_v_matches(V, V_ref, tol, tag):
    # Eigenvector signs are arbitrary per column: compare up to sign.
    signs = np.sign(np.sum(V * V_ref, axis=0))
    signs[signs == 0] = 1.0
    err = np.abs(V * signs - V_ref).max()
    assert err < tol, (tag, err)


def _selfcheck(init: str, nproc: int, pid: int, device: str,
               backend: str | None) -> None:
    """Worker body of the localhost check: one small frame per data row,
    trained dense, streaming and factored over the global mesh and held
    against the port's single-process plain route on the same frame; then
    the bucket-divergence phase (the rows land in different rank buckets
    and run at the largest); then a configuration mismatch, which must
    raise on every rank."""
    from nle_tpu_torch.ops.pipeline import (
        bucket_m,
        ka_eigh_host64,
        train_filter,
    )
    from nle_tpu_torch.ops.sampling import sample_grid
    from nle_tpu_torch.ops.transform import transform_eigenvalues

    dev = initialize(init, nproc, pid, device=device, backend=backend)
    try:
        mesh = make_global_mesh()
        row = mesh.data_index
        rng = np.random.default_rng(7 + row)   # a distinct frame a row
        chan = rng.integers(0, 256, (24, 32)).astype(np.float32)
        args = (3, 4, 50.0, 30.0, 5, 5)
        results = {}
        for streaming in (False, True):
            (V, S), = train_filters_multihost(chan[None], *args, mesh,
                                              streaming=streaming)
            results[streaming] = (V, S)
        V1, S1 = train_filter(chan, *args, device=dev, use_kernels=False)
        V1, S1 = V1.cpu().numpy(), S1.cpu().numpy()
        for streaming, (V, S) in results.items():
            tag = "streaming" if streaming else "dense"
            assert np.allclose(S, S1, rtol=2e-4, atol=1e-5), (tag, S, S1)
            _assert_v_matches(V, V1, 5e-3, tag)

        (flt,) = train_filters_multihost(chan[None], *args, mesh,
                                         streaming=True, factored=True)
        eig = flt.eigvals.cpu().numpy()
        assert np.allclose(eig, S1[:eig.shape[0]], rtol=2e-4, atol=1e-5)
        fS = transform_eigenvalues(flt.eigvals, [2.0, 3.0, 4.0, 1.0])
        out_f = flt.apply(chan, fS)
        V, S = results[False]
        fS1 = transform_eigenvalues(torch.from_numpy(S),
                                    [2.0, 3.0, 4.0, 1.0]).numpy()
        ref = V @ (fS1 * (V.T @ chan.reshape(-1)))
        assert np.abs(out_f.reshape(-1) - ref).max() < 0.1

        # Bucket divergence: at p = 150 the random frame keeps m = 150
        # (bucket 150), the flat one m ~ 64 (bucket 128): the step runs at
        # the larger bucket on both rows.
        chan2 = (np.full((40, 45), 77.0, np.float32) if row % 2
                 else rng.integers(0, 256, (40, 45)).astype(np.float32))
        args2 = (10, 15, 30.0, 30.0, 4, 5)
        if mesh.n_data > 1:
            g2 = sample_grid(40, 45, 10, 15)
            _, lam2, _ = ka_eigh_host64(
                chan2[g2.sel_rows, g2.sel_cols].astype(np.float64),
                g2.sel_rows, g2.sel_cols, 30.0, 30.0, 1e-10)
            ms = sharded.all_gather_world(np.array([lam2.shape[0]]), mesh)
            buckets = {bucket_m(int(mi), g2.n_samples) for mi in ms.ravel()}
            assert len(buckets) > 1, f"all buckets {buckets}"
        # Against the float64 route: the truncating chain amplifies every
        # f32 route's rounding, and on this frame the port's f32 routes
        # differ among themselves by up to 4e-3 relative (the dense body
        # is the one nearest float64).
        V1b, S1b = train_filter(chan2, *args2, device=dev,
                                dtype=torch.float64)
        V1b, S1b = V1b.cpu().numpy(), S1b.cpu().numpy()
        for streaming in (False, True):
            (V2, S2), = train_filters_multihost(chan2[None], *args2, mesh,
                                                streaming=streaming)
            k2 = S2.shape[0]
            tag = f"divergent-bucket-{'stream' if streaming else 'dense'}"
            # The JAX check's bounds for a truncating chain (m = 64 of 150).
            rtol, atol, vtol = ((2e-2, 1e-3, 5e-2) if streaming
                                else (2e-3, 1e-4, 2e-2))
            assert np.allclose(S2, S1b[:k2], rtol=rtol, atol=atol), (
                tag, S2, S1b)
            _assert_v_matches(V2, V1b[:, :k2], vtol, tag)
        _mismatch_raises(mesh, chan)
        print(f"multihost selfcheck pid={pid}/{nproc}: ok (dense + streaming "
              "+ factored + divergent-bucket x {dense,stream} match the "
              "single-process route; a config mismatch raised)", flush=True)
    finally:
        shutdown()


def _mismatch_raises(mesh, chan) -> None:
    """Every rank passes a different hx: each must raise ValueError."""
    try:
        train_filters_multihost(chan[None], 3, 4, 50.0 + mesh.rank, 30.0, 5,
                                5, mesh)
    except ValueError as e:
        assert "config mismatch" in str(e), e
    else:
        raise AssertionError("a config mismatch did not raise")


def repo_root() -> str:
    """The directory that holds the nle_tpu_torch package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def worker_env(threads: int | None = None) -> dict:
    """The environment of a localhost worker: the package importable, gloo
    on the loopback interface (unless set), and `threads` CPU threads."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo_root()] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    return env


def launch(commands: list, *, timeout: float,
           env: dict | None = None) -> list[str]:
    """Run one process per command (argv lists) side by side and return
    their outputs. When one exits nonzero or `timeout` seconds pass, every
    process still running is killed and RuntimeError names the failures
    with the tails of their output."""
    logs = [tempfile.TemporaryFile(mode="w+") for _ in commands]
    procs = [subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                              env=env, cwd=repo_root(), text=True)
             for cmd, log in zip(commands, logs)]
    deadline = time.monotonic() + timeout
    failure = None
    try:
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                failure = "failed"
                break
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                failure = f"timed out after {timeout} s"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failure:
        tails = "\n".join(
            f"--- worker {i} rc {p.returncode}:\n{out[-3000:]}"
            for i, (p, out) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"workers {failure}:\n{tails}")
    return outs


def file_init(directory: str) -> str:
    """A file:// init method in `directory` (a fresh file: no TCP port to
    race for)."""
    return "file://" + os.path.join(directory, "pg_init")


def run_localhost_workers(n_proc: int, *, device: str = "cuda",
                          backend: str | None = None,
                          timeout: float = 600.0) -> list[str]:
    """Spawn n_proc selfcheck workers on this host; raise if any fails or
    times out (dryrun_multihost's body)."""
    with tempfile.TemporaryDirectory() as tmp:
        cmds = [[sys.executable, "-m", "nle_tpu_torch.parallel.distributed",
                 "--selfcheck", f"--nproc={n_proc}", f"--pid={i}",
                 f"--init={file_init(tmp)}", f"--device={device}"]
                + ([f"--backend={backend}"] if backend else [])
                for i in range(n_proc)]
        return launch(cmds, timeout=timeout,
                      env=worker_env(1 if device == "cpu" else None))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = {"nproc": "2", "pid": "0", "init": None, "device": "cuda",
            "backend": None}
    selfcheck = False
    for a in argv:
        if a == "--selfcheck":
            selfcheck = True
        elif a.startswith("--") and "=" in a and a[2:].split("=")[0] in opts:
            key, val = a[2:].split("=", 1)
            opts[key] = val
        else:
            print(f"unknown argument {a!r}", file=sys.stderr)
            return 2
    if not selfcheck or opts["init"] is None:
        print("usage: python -m nle_tpu_torch.parallel.distributed "
              "--selfcheck --nproc=N --pid=I --init=METHOD "
              "[--device=cuda|cpu] [--backend=nccl|gloo]", file=sys.stderr)
        return 2
    _selfcheck(opts["init"], int(opts["nproc"]), int(opts["pid"]),
               opts["device"], opts["backend"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
