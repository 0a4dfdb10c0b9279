"""The reference's dense free functions in the port (ops/sinkhorn.sinkhorn,
ops/orthogonalize.orthogonalize, eigh_descending's methods,
utils/indexing, utils/visualize.plot_sampled_points) against nle_tpu's on
the CPU and against tests/oracle_numpy.py, on inputs made from a seed.
The cases are those of tests/test_sinkhorn.py, test_orthogonalize.py and
test_utils_aux.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import oracle_numpy as O
from nle_tpu.ops.orthogonalize import orthogonalize as _jax_orthogonalize
from nle_tpu.ops.sinkhorn import sinkhorn as _jax_sinkhorn
from nle_tpu.utils import indexing as jax_indexing
from nle_tpu.utils.visualize import plot_sampled_points as jax_plot
from nle_tpu_torch.ops.linalg import eigh_descending
from nle_tpu_torch.ops.orthogonalize import (
    orthogonalize,
    orthogonalize_factored,
)
from nle_tpu_torch.ops.sinkhorn import balanced_top, sinkhorn, sinkhorn_vectors
from nle_tpu_torch.utils import to_1d_index, to_2d_coords
from nle_tpu_torch.utils.visualize import plot_sampled_points

EPS = 1e-10
METHODS = ("xla", "host64", "host64-chain")

# nle_tpu's functions jitted whole: one compile a shape, against a compile
# of the fori_loop and of every op after it when called bare (3-4x slower
# here).
jax_sinkhorn = jax.jit(_jax_sinkhorn, static_argnums=(2, 3))
jax_orthogonalize = jax.jit(_jax_orthogonalize, static_argnums=(2, 3, 4))


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _sinkhorn_case(name, rng):
    """(phi, lam, iters, balanced): the four cases of test_sinkhorn.py;
    balanced marks those whose rows and columns sum to 1."""
    if name == "identity":          # test/test_filter.cpp:72-94
        return np.eye(2), np.ones(2), 10, True
    if name == "random5":           # test/test_filter.cpp:96-122
        U, D = eigh_descending(_t(rng.random((5, 5))), EPS)
        return U.numpy(), D.numpy(), 20, True
    if name == "oracle_n60_p8":
        n, p = 60, 8
        M = rng.random((p, p))
        M = (M + M.T) / 2 + p * np.eye(p)
        U, D = O.eigen_decomposition(M)
        return np.vstack([U, rng.random((n - p, p)) * 0.1]), D, 10, False
    # boundary_n40_m5: the block boundary is m = phi.cols(), not p.
    return rng.random((40, 5)), rng.random(5) + 0.5, 5, False


@pytest.mark.parametrize("case", ["identity", "random5", "oracle_n60_p8",
                                  "boundary_n40_m5"])
def test_sinkhorn_matches_nle_tpu_and_oracle(case, rng):
    phi, lam, iters, balanced = _sinkhorn_case(case, rng)
    n, m = phi.shape
    Wa, Wab = (x.numpy() for x in sinkhorn(_t(phi), _t(lam), iters, EPS))
    assert Wa.shape == (m, m) and Wab.shape == (m, n - m)
    Wa_j, Wab_j = jax_sinkhorn(jnp.asarray(phi, jnp.float64),
                               jnp.asarray(lam, jnp.float64), iters, EPS)
    Wa_o, Wab_o = O.sinkhorn(phi, lam, iters)
    for got, want in ((Wa, Wa_j), (Wab, Wab_j), (Wa, Wa_o), (Wab, Wab_o)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-12)
    if balanced:
        np.testing.assert_allclose(Wa, Wa.T, atol=1e-8)
        np.testing.assert_allclose(np.hstack([Wa, Wab]).sum(axis=1), 1.0,
                                   atol=1e-10)
        np.testing.assert_allclose(np.vstack([Wa, Wab.T]).sum(axis=0), 1.0,
                                   atol=1e-10)


@pytest.mark.parametrize("method", METHODS)
def test_orthogonalize_matches_nle_tpu_and_oracle(method, rng):
    # test/test_filter.cpp:126-153: random symmetric Wa (10, 10), Wab
    # (10, 90), k = 5; every eigh_method gives the same (V, S).
    p, n, k = 10, 100, 5
    Wa = rng.random((p, p))
    Wa = (Wa + Wa.T) / 2
    Wab = rng.random((p, n - p))
    V, S = (x.numpy() for x in orthogonalize(_t(Wa), _t(Wab), k, EPS,
                                             eigh_method=method))
    assert V.shape == (n, k) and S.shape == (k,) and (S != 0).any()
    nz = S != 0
    np.testing.assert_allclose(V[:, nz].T @ V[:, nz], np.eye(int(nz.sum())),
                               atol=1e-8)
    V_j, S_j = jax_orthogonalize(jnp.asarray(Wa), jnp.asarray(Wab), k, EPS,
                                 method)
    V_o, S_o = O.orthogonalize(Wa, Wab, k)
    for V_ref, S_ref in ((np.asarray(V_j), np.asarray(S_j)), (V_o, S_o)):
        r = S_ref.size
        np.testing.assert_allclose(S[:r], S_ref, atol=1e-10)
        # Eigenvector signs are each solver's own.
        np.testing.assert_allclose(np.abs(V[:, :r]), np.abs(V_ref),
                                   atol=1e-8)


def test_orthogonalize_dense_equals_factored(rng):
    # A real Sinkhorn factorization with the boundary at m: the dense form
    # on (Wa, Wab) equals the factored form that never builds Wab.
    n, m, k = 80, 6, 4
    phi = _t(rng.random((n, m)))
    lam = _t(rng.random(m) + 0.5)
    r, c = sinkhorn_vectors(phi, lam, 10, EPS)
    Ga, RGa, Wa = balanced_top(phi, lam, r, c, m)
    Wa_s, Wab = sinkhorn(phi, lam, 10, EPS)
    assert torch.equal(Wa_s, Wa)
    V_d, S_d = orthogonalize(Wa, Wab, k, EPS)
    V_f, S_f = orthogonalize_factored(Wa, RGa, phi[m:], c[m:], r[:m], Ga, k,
                                      EPS)
    np.testing.assert_allclose(S_f.numpy(), S_d.numpy(), atol=1e-12)
    np.testing.assert_allclose(V_f.numpy(), V_d.numpy(), atol=1e-10)


# float32 on a Nystrom factor of a Gaussian kernel (a positive W, so the
# balancing converges): the float32 unit roundoff is 6e-8. Over seeds 0-9
# on the CPU the port read at most 3.7e-7 of max |W| from nle_tpu's
# float32 Wa/Wab, 8.6e-6 on S and 1.2e-5 on |V| (from nle_tpu's float32 and
# from the float64 oracle alike); the bounds are about 5x those.
F32_TOL_W, F32_TOL_S, F32_TOL_V = 2e-6, 5e-5, 1e-4


@pytest.mark.parametrize("method", ["xla", "host64"])
def test_float32_chain_matches_nle_tpu(method, rng):
    n, p, k = 120, 10, 4
    x = rng.random((n, 2))
    K = np.exp(-((x[:, None] - x[None]) ** 2).sum(-1) / 0.05)
    lam64, phi64 = O.nystrom_approximation(K[:p, :p], K[:p, p:])
    phi, lam = phi64.astype(np.float32), lam64.astype(np.float32)
    Wa, Wab = sinkhorn(_t(phi, torch.float32), _t(lam, torch.float32), 10,
                       EPS)
    V, S = orthogonalize(Wa, Wab, k, EPS, eigh_method=method)
    assert Wa.dtype == V.dtype == S.dtype == torch.float32
    Wa_j, Wab_j = jax_sinkhorn(jnp.asarray(phi), jnp.asarray(lam), 10, EPS)
    V_j, S_j = jax_orthogonalize(Wa_j, Wab_j, k, EPS, method)
    assert Wa_j.dtype == jnp.float32
    scale = max(float(jnp.abs(Wa_j).max()), float(jnp.abs(Wab_j).max()))
    for got, want in ((Wa, Wa_j), (Wab, Wab_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=F32_TOL_W * scale, rtol=0)
    V_o, S_o = O.orthogonalize(*O.sinkhorn(phi64, lam64, 10), k)
    for V_ref, S_ref in ((np.asarray(V_j), np.asarray(S_j)), (V_o, S_o)):
        np.testing.assert_allclose(S.numpy(), S_ref, atol=F32_TOL_S)
        np.testing.assert_allclose(np.abs(V.numpy()), np.abs(V_ref),
                                   atol=F32_TOL_V)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_eigh_methods_agree(dtype, rng):
    n = 12
    A = rng.random((n, n))
    A = A @ A.T + np.diag(np.arange(n, dtype=np.float64))
    A[np.triu_indices(n, 1)] = 7.0       # only the lower triangle is read
    M = _t(A, dtype)
    out = {m: eigh_descending(M, EPS, m) for m in METHODS}
    U0, l0 = out["xla"]
    # float32: eigh's backward error is ~ n u ||A|| = 12 x 6e-8 x 50 = 4e-5
    # in the eigenvalues, that over the smallest gap (0.46) in the vectors.
    tol = 1e-10 if dtype == torch.float64 else 2e-4
    for U, lam in out.values():
        assert U.dtype == lam.dtype == dtype and U.device == M.device
        np.testing.assert_allclose(lam.numpy(), l0.numpy(),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(np.abs(U.numpy()), np.abs(U0.numpy()),
                                   atol=tol * 10)
    with pytest.raises(ValueError, match="host64_typo"):
        eigh_descending(M, EPS, "host64_typo")
    with pytest.raises(ValueError, match="bogus"):
        orthogonalize(M[:4, :4], M[:4, 4:], 2, EPS, eigh_method="bogus")


@pytest.mark.parametrize("kind", ["int", "numpy", "tensor"])
def test_index_roundtrip(kind, rng):
    ncols = 37
    rows = rng.integers(0, 50, 64)
    cols = rng.integers(0, ncols, 64)
    if kind == "int":
        assert to_1d_index(3, 4, 10) == 34
        assert to_2d_coords(34, 10) == (3, 4)
        pairs = [(int(r), int(c)) for r, c in zip(rows, cols)]
        for r, c in pairs:
            i = to_1d_index(r, c, ncols)
            assert i == jax_indexing.to_1d_index(r, c, ncols)
            assert to_2d_coords(i, ncols) == (r, c)
        return
    conv = (lambda a: a) if kind == "numpy" else torch.from_numpy
    idx = to_1d_index(conv(rows), conv(cols), ncols)
    np.testing.assert_array_equal(
        np.asarray(idx), jax_indexing.to_1d_index(rows, cols, ncols))
    r2, c2 = to_2d_coords(idx, ncols)
    np.testing.assert_array_equal(np.asarray(r2), rows)
    np.testing.assert_array_equal(np.asarray(c2), cols)


@pytest.mark.parametrize("shape,grid", [((24, 32, 3), (3, 4)),
                                        ((17, 45, 3), (4, 7)),
                                        ((40, 23), (5, 3))])
@pytest.mark.parametrize("radius", [0, 3])
def test_plot_sampled_points_bytes_equal(shape, grid, radius, rng):
    img = rng.integers(0, 256, shape, np.uint8)
    before = img.copy()
    color = (255, 0, 0) if len(shape) == 3 else 200
    got = plot_sampled_points(img, *grid, radius=radius, color=color)
    want = jax_plot(img, *grid, radius=radius, color=color)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert (got != img).any()
    np.testing.assert_array_equal(img, before)     # the input is untouched
