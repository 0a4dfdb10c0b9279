"""The port's pixel-sharded trainers and applies (nle_tpu_torch/parallel/
sharded.py) over gloo-CPU rank processes, against nle_tpu's
train_filter_sharded / apply_filter_*_sharded on make_mesh of the same
shape (the 8 virtual CPU devices), at the JAX tests' own tolerances
(tests/test_sharding.py: S rtol 2e-4, atol 1e-5; filter action max-abs
< 0.05, the int16 carrier < 2.0), and against the port's single-device CPU
routes.

The workers (tests/torch_sharded_worker.py) run once per mesh shape, all
three shapes side by side, and write each rank's results to npz files;
the cases below read them."""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu.parallel.sharded import (
    apply_filter_factored_sharded as j_apply_factored,
    apply_filter_sharded as j_apply,
    make_mesh as j_make_mesh,
    train_filter_sharded as j_train,
)
from nle_tpu_torch.models.factored import train_filter_factored
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import split_row_pad
from nle_tpu_torch.ops.pipeline import bucket_m, train_filter
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import transform_eigenvalues
from nle_tpu_torch.parallel.distributed import file_init, launch, worker_env

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_sharded_worker import (  # noqa: E402
    ARGS,
    CROP_ARGS,
    MIXED_ARGS,
    WEIGHTS,
)

SHAPES = [(1, 2), (2, 2), (1, 4)]
IDS = ["1x2", "2x2", "1x4"]


def _crops():
    """Two crops of a posterized synthetic frame whose kept ranks differ
    (47 and 48 of p = 48 at CROP_ARGS): structured, not uniform noise (the
    int16 carrier's validity domain)."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:200, 0:300].astype(np.float64)
    base = (120 + 60 * np.sin(xx / 37.0) * np.cos(yy / 23.0)
            + 30 * np.tanh((xx - 150) / 9.0) + rng.normal(0, 1.0, xx.shape))
    L = (np.round(base / 8) * 8).clip(0, 255).astype(np.float32)
    return np.stack([L[:120, :160], L[40:160, 100:260]])


def _inputs():
    rng = np.random.default_rng(3)
    batch = rng.integers(0, 256, (2, 24, 32)).astype(np.float32)
    img1 = rng.integers(0, 256, (80, 90)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 20, img1.shape), 0, 255
                   ).astype(np.float32)
    noise = np.rint(np.random.default_rng(0).uniform(0, 255, (1, 120, 120)))
    return dict(batch=batch, crops=_crops(), mixed=np.stack([img1, img2]),
                noise=noise.astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: [rank 0's results, rank 1's, ...]}: one launch a shape, the
    three launches side by side."""
    inputs = _inputs()
    jobs = {}
    for shape in SHAPES:
        d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
        np.savez(d / "inputs.npz", **inputs)
        n = shape[0] * shape[1]
        jobs[shape] = (d, [[sys.executable,
                            os.path.join(HERE, "torch_sharded_worker.py"),
                            f"--nproc={n}", f"--pid={i}",
                            f"--init={file_init(str(d))}",
                            f"--shape={shape[0]},{shape[1]}", f"--dir={d}"]
                           for i in range(n)])
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(len(jobs)) as pool:
        futs = {s: pool.submit(launch, cmds, timeout=300, env=worker_env(1))
                for s, (_, cmds) in jobs.items()}
        for f in futs.values():
            f.result()
    return {s: [dict(np.load(d / f"rank{r}.npz"))
                for r in range(s[0] * s[1])]
            for s, (d, _) in jobs.items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def jax_runs(inputs):
    """nle_tpu's sharded results on make_mesh of each shape."""
    out = {}
    b = inputs["batch"]
    for shape in SHAPES:
        mesh = j_make_mesh(*shape)
        r = {}
        r["dense"] = j_train(b, *ARGS, mesh)
        r["stream"] = j_train(b, *ARGS, mesh, streaming=True)
        flts = j_train(b, *ARGS, mesh, streaming=True, factored=True)
        r["fact"] = [(np.asarray(f.eigvals), j_apply_factored(
            f, b[i], jtransform(f.eigvals, WEIGHTS), mesh))
            for i, f in enumerate(flts)]
        os.environ["NLE_SINKHORN_INT16"] = "on"
        try:
            r["int16"] = j_train(inputs["crops"], *CROP_ARGS, mesh)
        finally:
            del os.environ["NLE_SINKHORN_INT16"]
        out[shape] = r
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-device CPU routes on the same frames: dense f32
    (the assembled K4 route), the split int16 route, streaming, factored."""
    b, crops = inputs["batch"], inputs["crops"]
    out = {}
    os.environ["NLE_SINKHORN_INT16"] = "off"
    try:
        out["dense"] = [train_filter(c, *ARGS, device="cpu") for c in b]
    finally:
        del os.environ["NLE_SINKHORN_INT16"]
    out["int16"] = [train_filter(c, *CROP_ARGS, device="cpu") for c in crops]
    out["stream"] = [train_filter(c, *ARGS, device="cpu", streaming=True)
                     for c in b]
    out["fact"] = [train_filter_factored(c, *ARGS, device="cpu") for c in b]
    return out


def _action(V, S, chan):
    """The filter action V f(S) V^T c in float64, f(S) from S by nle_tpu's
    transform (the JAX test's comparison)."""
    V = np.asarray(V, np.float64)
    fS = np.asarray(jtransform(jnp.asarray(np.asarray(S, np.float32)),
                               WEIGHTS), np.float64)
    c = np.asarray(chan, np.float64).reshape(-1)
    return V @ (fS * (V.T @ c))


def _hold(V, S, V_ref, S_ref, frames, action_tol, s_tol=True):
    for i in range(frames.shape[0]):
        k = np.asarray(S_ref[i]).size
        if s_tol:
            np.testing.assert_allclose(np.asarray(S[i])[:k],
                                       np.asarray(S_ref[i]),
                                       rtol=2e-4, atol=1e-5)
        a = _action(np.asarray(V[i])[:, :k], S_ref[i], frames[i])
        b = _action(np.asarray(V_ref[i]), S_ref[i], frames[i])
        assert np.abs(a - b).max() < action_tol


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("case", ["dense", "stream"])
def test_sharded_matches_jax(runs, jax_runs, inputs, shape, case):
    r = runs[shape][0]
    V_j, S_j = jax_runs[shape][case]
    _hold(r[f"{case}_V"], r[f"{case}_S"], np.asarray(V_j), np.asarray(S_j),
          inputs["batch"], 0.05)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("case", ["dense", "stream"])
def test_sharded_matches_single_device(runs, single, inputs, shape, case):
    r = runs[shape][0]
    V1 = [v.numpy() for v, _ in single[case]]
    S1 = [s.numpy() for _, s in single[case]]
    _hold(r[f"{case}_V"], r[f"{case}_S"], V1, S1, inputs["batch"], 0.05)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_int16_matches(runs, jax_runs, single, inputs, shape):
    """NLE_SINKHORN_INT16=on: the carrier (shard-local column scales) on
    the plain K3, within 2.0 of nle_tpu's sharded int16 twin and of the
    port's single-device split int16 route; the crops' kept ranks
    differ."""
    crops = inputs["crops"]
    g = sample_grid(120, 160, *CROP_ARGS[:2])
    from nle_tpu_torch.ops.pipeline import ka_eigh_host64

    ms = {ka_eigh_host64(c[g.sel_rows, g.sel_cols].astype(np.float64),
                         g.sel_rows, g.sel_cols, *CROP_ARGS[2:4],
                         1e-10)[1].shape[0] for c in crops}
    assert len(ms) == 2
    r = runs[shape][0]
    assert np.all((r["int16_crush"] >= 0) & (r["int16_crush"] < 0.2))
    V_j, S_j = jax_runs[shape]["int16"]
    for refV, refS in ((np.asarray(V_j), np.asarray(S_j)),
                       ([v.numpy() for v, _ in single["int16"]],
                        [s.numpy() for _, s in single["int16"]])):
        _hold(r["int16_V"], r["int16_S"], refV, refS, crops, 2.0,
              s_tol=False)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_guard_retrains_through_f32(runs, shape):
    """With the carrier engaged as on the card, uniform noise trips the
    guard on the pixel group's all-reduced crush statistic (> 0.2), and the
    element retrains through the f32 body: V and S bitwise the f32 run's,
    on every rank."""
    for r in runs[shape]:
        crush, retrained, same_v, same_s = r["guard"]
        assert crush > 0.2 and retrained and same_v and same_s, r["guard"]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_factored_matches(runs, jax_runs, single, inputs, shape):
    """factored=True: eigenvalues at the S tolerance and the sharded apply
    (K10, one k-sized all_reduce, K11) within 0.05 of nle_tpu's factored
    sharded apply and of the port's single-device factored filter."""
    r = runs[shape][0]
    assert r["fact_u8"].all()
    for i, chan in enumerate(inputs["batch"]):
        eig_j, out_j = jax_runs[shape]["fact"][i]
        np.testing.assert_allclose(r[f"fact_eig{i}"], eig_j, rtol=2e-4,
                                   atol=1e-5)
        assert np.abs(r[f"fact_out{i}"] - np.asarray(out_j)).max() < 0.05
        f1 = single["fact"][i]
        out1 = f1.apply(chan, transform_eigenvalues(f1.eigvals, WEIGHTS))
        assert np.abs(r[f"fact_out{i}"] - out1).max() < 0.05


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_factored_apply_cache(runs, shape):
    """The rank's operands are cached on the filter per mesh: reused by a
    second apply on the same mesh (same output), rebuilt for a new mesh."""
    assert runs[shape][0]["fact_cache"].all()


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_dense_apply_matches(runs, inputs, shape):
    """apply_filter_sharded on the trained V: nle_tpu's apply_filter_sharded
    on the same V and mesh shape, and the plain product, within 1e-3."""
    r = runs[shape][0]
    V, S = r["dense_V"][0], r["dense_S"][0]
    chan = inputs["batch"][0]
    fS = transform_eigenvalues(torch.from_numpy(S), WEIGHTS).numpy()
    out_j = np.asarray(j_apply(jnp.asarray(V), jnp.asarray(fS),
                               jnp.asarray(chan), j_make_mesh(*shape)))
    np.testing.assert_allclose(r["apply_out"], out_j, atol=1e-3)
    plain = (V.astype(np.float64) @ (fS * (V.T.astype(np.float64)
                                           @ chan.reshape(-1))))
    np.testing.assert_allclose(r["apply_out"].reshape(-1), plain, atol=1e-3)


def test_sharded_mixed_buckets_pad_to_data_axis(runs, inputs, monkeypatch):
    """Elements in different rank buckets (NLE_M_BUCKET=1: m = 25 and 23)
    form groups smaller than the data axis; each is padded by repeating
    its last element and matches nle_tpu's sharded trainer on make_mesh(2,
    2) and the port's single-device route."""
    monkeypatch.setenv("NLE_M_BUCKET", "1")
    mixed = inputs["mixed"]
    r = runs[(2, 2)][0]
    V_j, S_j = j_train(mixed, *MIXED_ARGS, j_make_mesh(2, 2))
    _hold(r["mixed_V"], r["mixed_S"], np.asarray(V_j), np.asarray(S_j),
          mixed, 0.05)
    monkeypatch.setenv("NLE_SINKHORN_INT16", "off")
    outs = [train_filter(c, *MIXED_ARGS, device="cpu") for c in mixed]
    _hold(r["mixed_V"], r["mixed_S"], [v.numpy() for v, _ in outs],
          [s.numpy() for _, s in outs], mixed, 0.05)


@pytest.mark.parametrize("which", range(3))
def test_sharded_checks_raise(runs, inputs, which):
    """The JAX trainer's refusals, raised before any collective on every
    rank: factored without streaming, factored or streaming off float32."""
    kws = [dict(factored=True),
           dict(streaming=True, factored=True, dtype=jnp.float64),
           dict(streaming=True, dtype=jnp.float64)]
    with pytest.raises(ValueError) as e:
        j_train(inputs["batch"], *ARGS, j_make_mesh(1, 2), **kws[which])
    head = str(e.value).split("(")[0].split(";")[0]
    for ranks in runs.values():
        for r in ranks:
            assert str(r["errors"][which]).startswith(head), (
                r["errors"][which], str(e.value))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_collective_payloads_are_m_sized(runs, shape):
    """Every payload of the one _psum helper holds at most mb^2 elements
    (the Sb gram) and fewer than the rank's rows: no N-sized all_reduce."""
    g = sample_grid(24, 32, *ARGS[:2])
    p = g.n_samples
    mb = bucket_m(p, p)
    for r in runs[shape]:
        for tag in ("dense", "stream", "fact"):
            sizes = r[f"{tag}_psum"]
            assert sizes.size > 0
            assert sizes.max() <= mb * mb, (tag, sizes.max(), mb)
            assert sizes.max() < r[f"{tag}_nb_local"], tag


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_phib_block_is_the_ranks_rows(runs, shape):
    """Each rank builds only its block of the padded rest rows: nb_pad /
    n_pixel rows, phi_b zero-tailed to split_row_pad of that, and the
    ranks' valid rows tile the rest block in order."""
    n_data, n_pixel = shape
    nb = 24 * 32 - sample_grid(24, 32, *ARGS[:2]).n_samples
    nb_pad = -(-nb // n_pixel) * n_pixel
    for rank, r in enumerate(runs[shape]):
        nb_local = int(r["dense_nb_local"])
        assert nb_local == nb_pad // n_pixel
        assert tuple(r["dense_phib_shape"]) == (split_row_pad(nb_local), 128)
        lo, hi = r["dense_rows"]
        j = rank % n_pixel
        assert (lo, hi) == (min(j * nb_local, nb),
                            min((j + 1) * nb_local, nb))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_host_work_once_per_pixel_group(runs, shape):
    """Stage 1 and the host chain ran on each pixel group's first rank
    only; the other ranks got them by broadcast."""
    n_pixel = shape[1]
    for rank, r in enumerate(runs[shape]):
        stage1, chain = r["host_work"]
        if rank % n_pixel == 0:
            assert stage1 > 0 and chain > 0
        else:
            assert stage1 == 0 and chain == 0, (rank, stage1, chain)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_sharded_every_rank_gets_the_same_result(runs, shape):
    ranks = runs[shape]
    for key in ("dense_V", "dense_S", "int16_V", "stream_V", "fact_eig0",
                "fact_out0", "fact_out1", "apply_out", "mixed_V"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
