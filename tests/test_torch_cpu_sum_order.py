"""The CPU dense route's bits do not depend on the CPU's math libraries'
run-time choices.

An fp32 matrix product on the CPU sums in the order of the BLAS's code
path and thread split, and torch's CPU exp goes through vector math code
whose last bit follows the CPU and the library's settings (MKL_CBWR), so
the port's CPU dense route gave other bits in some fresh processes. The
host chain divides by sqrt of Wa's eigenvalues down to eps (1e-10), and
phi_b = K_AB Uinv carries 1/lambda up to 1e10, so a last-bit change could
move the filter's eigenvalues far (a train gave a largest eigenvalue of
37515.4 where the others gave 0.998351). On the CPU the route's plain
versions now round once from float64: the affinity block's exp, the plain
K1, K6 and K7 products, and the Sinkhorn loop's top-block matvecs and the
plain K3's x (`rowdot64`, `colsum64`). The thread tests run one
function at 1, 2, 3 and 4 threads and require the same bits; the exp test
requires every entry to be float64's exp rounded once.
"""

import numpy as np
import pytest
import torch

from nle_tpu_torch.ops.affinity import affinity_block, bandwidth_weights
from nle_tpu_torch.ops.kernels import affinity_kernel as tak
from nle_tpu_torch.ops.kernels import scaled_matmul_kernel as tsm
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsk

THREADS = (1, 2, 3, 4)


def _at_each_thread_count(fn):
    before = torch.get_num_threads()
    outs = []
    try:
        for n in THREADS:
            torch.set_num_threads(n)
            outs.append(fn())
    finally:
        torch.set_num_threads(before)
    return outs


def _split_operands(seed=0, p=600, mpad=512, npad_b=8192):
    """Operands shaped as the 208x304 rock2 train's split stage 2a (p =
    600, mpad 512): a top block with Uinv-like column scales and a rest
    block of positive affinity-like entries with exact-zero pad columns."""
    rng = np.random.default_rng(seed)
    m = 400
    Um = np.zeros((p, mpad), np.float32)
    Um[:, :m] = rng.standard_normal((p, m)) / np.sqrt(p)
    lam = np.zeros(mpad, np.float32)
    lam[:m] = np.sort(rng.uniform(1e-6, 1.0, m))[::-1]
    phib = np.zeros((npad_b, mpad), np.float32)
    phib[:npad_b - 37, :m] = rng.uniform(0, 1, (npad_b - 37, m)) * lam[:m]
    return (torch.from_numpy(Um), torch.from_numpy(lam),
            torch.from_numpy(phib))


def test_split_sinkhorn_vectors_same_bits_at_every_thread_count():
    Um, lam, phib = _split_operands()
    outs = _at_each_thread_count(
        lambda: tsk.sinkhorn_vectors_split(Um, lam, phib, 3, 1e-10))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_plain_halfstep_same_bits_at_every_thread_count(dtype):
    _, lam, phib = _split_operands(seed=1)
    if dtype == "int16":
        Q, scale, _ = tsk.quantize_int16(phib)
        t = lam * scale
    else:
        Q, t = phib, lam
    outs = _at_each_thread_count(
        lambda: tsk.sinkhorn_halfstep_plain(Q, t, 1e-10))
    for x, s in outs[1:]:
        assert torch.equal(x, outs[0][0]) and torch.equal(s, outs[0][1])


def test_plain_gram_same_bits_at_every_thread_count():
    _, _, phib = _split_operands(seed=2)
    c = torch.from_numpy(np.random.default_rng(3).uniform(
        0.5, 2.0, (phib.shape[0], 1)).astype(np.float32))
    outs = _at_each_thread_count(lambda: tsm.scaled_gram_plain(phib, c))
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
    # The float64 sum rounded once: within half an fp32 ulp (relative
    # 2^-24) of a float64 gram of the same fp32 diag(c) phi.
    cphi = (phib * c).double()
    want = cphi.T @ cphi
    rel = ((outs[0].double() - want).abs()
           / want.abs().clamp_min(1e-300)).max()
    assert float(rel) <= 2.0 ** -24


def _features(seed, n):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.stack(
        [rng.integers(0, 208, n), rng.integers(0, 304, n),
         rng.integers(0, 256, n)], axis=1).astype(np.float32))


def test_affinity_block_exp_is_float64_rounded_once():
    """Each entry is exp of the fp32 argument in float64 (NumPy's, not
    torch's), rounded once to float32: no CPU math library's last bit."""
    sw, pw = bandwidth_weights(500.0, 10.0)
    fa, fb = _features(4, 600), _features(5, 4096)
    got = affinity_block(fa, fb, sw, pw).numpy()
    a, b = fa.numpy(), fb.numpy()
    dr = a[:, None, 0] - b[None, :, 0]
    dc = a[:, None, 1] - b[None, :, 1]
    dy = a[:, None, 2] - b[None, :, 2]
    arg = -(np.float32(sw) * (dr * dr + dc * dc) + np.float32(pw) * (dy * dy))
    assert arg.dtype == np.float32
    np.testing.assert_array_equal(got, np.exp(arg.astype(np.float64))
                                  .astype(np.float32))


def test_plain_affinity_matmul_same_bits_at_every_thread_count():
    sw, pw = bandwidth_weights(500.0, 10.0)
    fa, fb = _features(6, 600), _features(7, 20000)
    B = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (600, 512)).astype(np.float32) * 1e4)
    outs = _at_each_thread_count(
        lambda: tak.affinity_matmul_plain(fa, fb, B, sw, pw))
    for got in outs[1:]:
        assert torch.equal(got, outs[0])


def test_plain_scaled_matmul_same_bits_at_every_thread_count():
    _, _, phib = _split_operands(seed=9)
    rng = np.random.default_rng(10)
    c = torch.from_numpy(rng.uniform(0.5, 2.0, (phib.shape[0], 1))
                         .astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((phib.shape[1], 64))
                         .astype(np.float32))
    outs = _at_each_thread_count(lambda: tsm.scaled_matmul_plain(phib, c, B))
    for got in outs[1:]:
        assert torch.equal(got, outs[0])
