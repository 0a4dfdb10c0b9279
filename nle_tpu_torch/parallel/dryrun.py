"""Dry runs of the multi-GPU paths over gloo-CPU processes (the port's
counterparts of __graft_entry__.py's dryrun_multichip and
dryrun_multihost): they need no card, so any machine can run the
sharding code end to end.

    python -c "from nle_tpu_torch.parallel.dryrun import dryrun_multichip; \\
        dryrun_multichip(4)"

dryrun_multichip(n) spawns n rank processes, lays them out as a
(2, n / 2) mesh when n is an even 4 or more, else (1, n), and trains a
small batch dense, streaming and factored with both applies, each check as
the JAX dry run makes it. dryrun_multihost(n) runs the multi-process
selfcheck (parallel/distributed.py). Each raises when a worker fails or
times out; every worker is stopped either way.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np


def dryrun_multihost(n_proc: int = 2, timeout: float = 600.0) -> None:
    from nle_tpu_torch.parallel.distributed import run_localhost_workers

    run_localhost_workers(int(n_proc), device="cpu", timeout=timeout)


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    from nle_tpu_torch.parallel.distributed import (
        file_init,
        launch,
        worker_env,
    )

    n = int(n_devices)
    with tempfile.TemporaryDirectory() as tmp:
        launch([[sys.executable, "-m", "nle_tpu_torch.parallel.dryrun",
                 f"--nproc={n}", f"--pid={i}", f"--init={file_init(tmp)}"]
                for i in range(n)], timeout=timeout, env=worker_env(1))


def _multichip_worker(n: int, pid: int, init: str) -> None:
    import torch

    from nle_tpu_torch.ops.transform import transform_eigenvalues
    from nle_tpu_torch.parallel.distributed import initialize, shutdown
    from nle_tpu_torch.parallel.sharded import (
        apply_filter_factored_sharded,
        apply_filter_sharded,
        make_mesh,
        train_filter_sharded,
    )

    initialize(init, n, pid, device="cpu")
    try:
        n_data = 2 if n % 2 == 0 and n >= 4 else 1
        mesh = make_mesh(n_data, n // n_data)
        rng = np.random.default_rng(0)
        batch = rng.integers(0, 256, (n_data, 24, 32)).astype(np.float32)
        args = (3, 4, 50.0, 30.0, 5, 5)
        w = [2.0, 3.0, 4.0, 1.0]
        V, S = train_filter_sharded(batch, *args, mesh)
        fS = transform_eigenvalues(S[0], w)
        out = apply_filter_sharded(V[0], fS, torch.from_numpy(batch[0]),
                                   mesh).numpy()
        assert np.isfinite(out).all()
        # The phi-free body agrees with the dense one.
        _, S2 = train_filter_sharded(batch, *args, mesh, streaming=True)
        assert np.allclose(S2.numpy(), S.numpy(), rtol=2e-4, atol=1e-5)
        # The V-free factored filters and their sharded apply.
        flts = train_filter_sharded(batch, *args, mesh, streaming=True,
                                    factored=True)
        assert np.allclose(flts[0].eigvals.numpy(), S[0].numpy(),
                           rtol=2e-4, atol=1e-5)
        fS0 = transform_eigenvalues(flts[0].eigvals, w)
        out_f = apply_filter_factored_sharded(flts[0], batch[0], fS0, mesh)
        assert np.abs(out_f - out).max() < 0.1
        print(f"dryrun_multichip rank {pid}/{n} mesh ({n_data}, "
              f"{n // n_data}): ok", flush=True)
    finally:
        shutdown()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = dict(a[2:].split("=", 1) for a in argv if a.startswith("--")
                and "=" in a)
    if set(opts) != {"nproc", "pid", "init"}:
        print("usage: python -m nle_tpu_torch.parallel.dryrun --nproc=N "
              "--pid=I --init=METHOD", file=sys.stderr)
        return 2
    _multichip_worker(int(opts["nproc"]), int(opts["pid"]), opts["init"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
