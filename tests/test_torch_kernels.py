"""Each kernel module of the port against the JAX package's Pallas kernel
run in interpret mode (as tests/test_pallas_kernels.py runs it), on the
same numpy-made inputs. On the CPU every wrapper takes its plain PyTorch
version; the CUDA kernels themselves are compared with those plain versions
by the `cuda`-marked tests below (skipped without a card) and by
chip_smoke.py."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.ops.pallas.affinity_kernel import affinity_matmul_pallas
from nle_tpu.ops.pallas.scaled_matmul_kernel import (
    scaled_gram_pallas,
    scaled_matmul_pallas,
)
from nle_tpu.ops.pallas.sinkhorn_kernel import (
    pack_pairs_int32,
    sinkhorn_halfstep_manual,
)
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels.affinity_kernel import (
    affinity_matmul_kernel,
    affinity_matmul_plain,
)
from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import (
    scaled_gram,
    scaled_gram_plain,
    scaled_matmul,
    scaled_matmul_plain,
)
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
    quantize_int16,
    sinkhorn_halfstep,
    sinkhorn_halfstep_plain,
)

U = 2.0 ** -24   # fp32 unit roundoff
EPS = 1e-10


def _features(rng, n):
    return np.stack([rng.integers(0, 200, n), rng.integers(0, 300, n),
                     rng.integers(0, 256, n)], axis=1).astype(np.float32)


@pytest.fixture()
def affinity_inputs():
    rng = np.random.default_rng(0)
    p, q, m = 100, 900, 60
    f = _features(rng, p + q)
    B = (rng.standard_normal((p, m)) * 0.1).astype(np.float32)
    sw, pw = bandwidth_weights(50.0, 20.0)
    return f[:p], f[p:], B, sw, pw


def _abs_bound_affinity(fa, fb, B, sw, pw):
    """(|K| |B|) in float64: the scale of every fp32 rounding error of the
    p-term contraction."""
    f64 = [np.asarray(a, np.float64) for a in (fa, fb)]
    d = [(f64[1][:, None, i] - f64[0][None, :, i]) ** 2 for i in range(3)]
    K = np.exp(-(sw * (d[0] + d[1]) + pw * d[2]))
    return K @ np.abs(B.astype(np.float64))


@pytest.mark.parametrize("out_rows", [None, 1024])
def test_affinity_matches_pallas_interpret(affinity_inputs, out_rows):
    fa, fb, B, sw, pw = affinity_inputs
    q, m = fb.shape[0], B.shape[1]
    got = affinity_matmul_kernel(torch.from_numpy(fa), torch.from_numpy(fb),
                                 torch.from_numpy(B), sw, pw,
                                 out_rows=out_rows).numpy()
    want = np.asarray(affinity_matmul_pallas(
        jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(B), jnp.float32(sw),
        jnp.float32(pw), interpret=True, out_rows=out_rows))
    if out_rows is not None:
        assert got.shape == want.shape == (out_rows, 128)
        # The direct-write tail must be exact zeros (pad features would
        # give nonzero affinities).
        np.testing.assert_array_equal(got[q:], 0.0)
        np.testing.assert_array_equal(got[:, m:], 0.0)
        got, want = got[:q, :m], want[:q, :m]
    # Two fp32 p-term contractions in different orders, plus exp's ulps:
    # |got - want| <= (2p + 4) u (|K| |B|).
    bound = (2 * fa.shape[0] + 4) * U * _abs_bound_affinity(fa, fb, B, sw, pw)
    assert np.all(np.abs(got - want) <= bound)


def _quantized_problem():
    rng = np.random.default_rng(7)
    n, mpad = 2048, 128
    base = np.abs(rng.standard_normal((n, mpad))) * 0.3 + 0.05
    phi = (base * np.geomspace(1.0, 1e4, mpad)[None, :]).astype(np.float32)
    phi[1900:] = 0.0                     # zero pad rows, as in stage 2a
    t = (rng.uniform(0.5, 1.5, mpad) / np.geomspace(1.0, 1e4, mpad) ** 2
         ).astype(np.float32)
    return phi, t


def test_sinkhorn_int16_matches_manual_kernel_interpret():
    """K3 against the TPU kernel's packed-int16 branch on the same quantized
    values (pair-packed for the JAX side). The TPU splits ints and t/x into
    bf16 pieces and drops the lo*lo term, so the two differ by ~1e-5
    relative; against a float64 numpy half-step on the same integers the
    port is at fp32 rounding."""
    phi, t = _quantized_problem()
    q16, scale, _ = quantize_int16(torch.from_numpy(phi))
    tq = (scale * torch.from_numpy(t)).contiguous()
    x, s = sinkhorn_halfstep(q16, tq, EPS)
    x, s = x.numpy(), s.numpy()
    q32 = pack_pairs_int32(jnp.asarray(q16.numpy().astype(np.int32)))
    xj, sj = sinkhorn_halfstep_manual(q32, jnp.asarray(tq.numpy()), EPS,
                                      chunk=256, interpret=True)
    xj, sj = np.asarray(xj), np.asarray(sj)
    live = slice(0, 1900)
    np.testing.assert_allclose(x[live], xj[live], rtol=1e-4)
    np.testing.assert_array_equal(x[1900:], 0.0)
    np.testing.assert_array_equal(xj[1900:], 0.0)
    np.testing.assert_allclose(s, sj, rtol=1e-4)
    # Tight against float64 on the very same integers: positive data, so
    # the fp32 w error is <= (mpad + 2) u relative and s's <= (n + 2) u.
    Q = q16.numpy().astype(np.float64)
    w64 = Q @ tq.numpy().astype(np.float64)
    x64 = np.where(np.abs(w64) >= EPS, 1.0 / np.where(w64 == 0, 1, w64), 0.0)
    np.testing.assert_allclose(x, x64, rtol=(128 + 2) * U * 2)
    s64 = Q.T @ x.astype(np.float64)
    np.testing.assert_allclose(s, s64, rtol=(2048 + 2) * U)


def test_sinkhorn_f32_matches_manual_kernel_interpret():
    """K4: the same half-step on the f32 factor. Both sides are fp32
    contractions in different orders: positive data bounds the relative
    error of w by (mpad + 2) u per side and of s by (n + 2) u."""
    phi, t = _quantized_problem()
    x, s = sinkhorn_halfstep(torch.from_numpy(phi), torch.from_numpy(t), EPS)
    xj, sj = sinkhorn_halfstep_manual(jnp.asarray(phi), jnp.asarray(t), EPS,
                                      chunk=256, interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj),
                               rtol=2 * (128 + 2) * U)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj),
                               rtol=2 * (2048 + 2 * 128 + 2) * U)


@pytest.fixture()
def scaled_inputs():
    rng = np.random.default_rng(11)
    n, npad, m, mpad = 1500, 2048, 37, 128
    phi = np.zeros((npad, mpad), np.float32)
    phi[:n, :m] = rng.standard_normal((n, m))
    c = np.zeros((npad, 1), np.float32)
    c[5:n, 0] = rng.random(n - 5)
    B = np.zeros((mpad, 128), np.float32)
    B[:m, :7] = rng.standard_normal((m, 7))
    return phi, c, B


def test_scaled_gram_matches_pallas_interpret(scaled_inputs):
    phi, c, _ = scaled_inputs
    got = scaled_gram(torch.from_numpy(phi), torch.from_numpy(c)).numpy()
    want = np.asarray(scaled_gram_pallas(jnp.asarray(phi), jnp.asarray(c),
                                         interpret=True))
    cphi = np.abs(c.astype(np.float64) * phi)
    # n-term fp32 sums in two orders: |got - want| <= 2 (n + 2) u |cphi|^T|cphi|.
    bound = 2 * (phi.shape[0] + 2) * U * (cphi.T @ cphi)
    assert np.all(np.abs(got - want) <= bound)


def test_scaled_matmul_matches_pallas_interpret(scaled_inputs):
    phi, c, B = scaled_inputs
    got = scaled_matmul(torch.from_numpy(phi), torch.from_numpy(c),
                        torch.from_numpy(B)).numpy()
    want = np.asarray(scaled_matmul_pallas(jnp.asarray(phi), jnp.asarray(c),
                                           jnp.asarray(B), interpret=True))
    cphi = np.abs(c.astype(np.float64) * phi)
    bound = 2 * (phi.shape[1] + 2) * U * (cphi @ np.abs(B.astype(np.float64)))
    assert np.all(np.abs(got - want) <= bound)


def test_cpu_wrappers_launch_nothing(affinity_inputs, scaled_inputs):
    """A CPU tensor takes the plain version, and only a kernel launch
    counts."""
    _build.reset_launches()
    fa, fb, B, sw, pw = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for a in affinity_inputs)
    got = affinity_matmul_kernel(fa, fb, B, sw, pw)
    torch.testing.assert_close(got, affinity_matmul_plain(fa, fb, B, sw, pw),
                               rtol=0, atol=0)
    phi, c, Bs = (torch.from_numpy(a) for a in scaled_inputs)
    torch.testing.assert_close(scaled_gram(phi, c), scaled_gram_plain(phi, c),
                               rtol=0, atol=0)
    torch.testing.assert_close(scaled_matmul(phi, c, Bs),
                               scaled_matmul_plain(phi, c, Bs), rtol=0, atol=0)
    t = torch.ones(phi.shape[1])
    for a, b in zip(sinkhorn_halfstep(phi, t, EPS),
                    sinkhorn_halfstep_plain(phi, t, EPS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_wrappers_refuse_other_devices():
    """Neither mixed devices nor a non-CPU, non-CUDA device falls back to
    the plain version."""
    phi = torch.zeros((64, 64), device="meta")
    c = torch.zeros((64, 1), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        scaled_gram(phi, c)
    with pytest.raises(ValueError, match="CUDA device"):
        scaled_matmul(torch.zeros((64, 64)), torch.zeros((64, 1)),
                      torch.zeros((64, 64), device="meta"))
    with pytest.raises(TypeError):
        sinkhorn_halfstep(torch.zeros((64, 64), dtype=torch.float64),
                          torch.zeros(64), EPS)


def test_kernel_sources_keep_the_numerical_contract():
    """No fast-math, no approximate exp, no float atomics anywhere in the
    CUDA sources or the build flags."""
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    names = sorted(os.listdir(_build.CSRC_DIR))
    assert {"affinity.cu", "sinkhorn.cu", "scaled_matmul.cu"} <= set(names)
    for name in names:
        with open(os.path.join(_build.CSRC_DIR, name)) as fh:
            code = re.sub(r"//[^\n]*", "", fh.read())
        for banned in ("__expf", "use_fast_math", "atomicAdd", "__fdividef"):
            assert banned not in code, (name, banned)


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda, affinity_inputs,
                                           scaled_inputs):
    """Each CUDA kernel against its plain version on the card, with the
    error bounds of the CPU tests above, and each launch counted once."""
    _build.reset_launches()
    fa, fb, B = (torch.from_numpy(a).to(cuda) for a in affinity_inputs[:3])
    sw, pw = affinity_inputs[3:]
    got = affinity_matmul_kernel(fa, fb, B, sw, pw, out_rows=1024)
    want = affinity_matmul_plain(fa, fb, B, sw, pw, out_rows=1024)
    assert torch.all(got[fb.shape[0]:] == 0)
    torch.testing.assert_close(got, want, rtol=(2 * 100 + 4) * U, atol=1e-6)
    phi, c, Bs = (torch.from_numpy(a).to(cuda) for a in scaled_inputs)
    torch.testing.assert_close(scaled_gram(phi, c), scaled_gram_plain(phi, c),
                               rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(scaled_matmul(phi, c, Bs),
                               scaled_matmul_plain(phi, c, Bs),
                               rtol=1e-5, atol=1e-5)
    qphi, t = _quantized_problem()
    q16, scale, _ = quantize_int16(torch.from_numpy(qphi).to(cuda))
    tq = (scale * torch.from_numpy(t).to(cuda)).contiguous()
    for Q, tt in ((q16, tq), (torch.from_numpy(qphi).to(cuda),
                              torch.from_numpy(t).to(cuda))):
        for a, b in zip(sinkhorn_halfstep(Q, tt, EPS),
                        sinkhorn_halfstep_plain(Q, tt, EPS)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "affinity_matmul": 1, "sinkhorn_halfstep_int16": 1,
        "sinkhorn_halfstep_f32": 1, "scaled_gram": 1, "scaled_matmul": 1}
