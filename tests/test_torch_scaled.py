"""K6 (scaled gram) and K7 (scaled matmul): the row plan of K6's lower-
triangle kernel, the width K7's callers pass, and, on the card, both
kernels against their plain versions.

The CPU runs the kernels' plain versions (tests/test_torch_kernels.py holds
them to the interpreted Pallas kernels); what the CUDA kernels add on top
(the split and chain plan, the narrower B) is pure Python, checked here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nle_tpu.ops.pallas.scaled_matmul_kernel import scaled_matmul_pallas
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import scaled_matmul_kernel as tsm

U = 2.0 ** -24
# chip_smoke.py's bound on K6, relative to |c phi|^T |c phi|.
GRAM_SUM_TOL = 2.5e-4

PLAN_SHAPES = [
    (2048, 128), (20544, 128), (600064, 640), (1011712, 640),
    (4 * 2 ** 20, 640), (2 ** 17 + 64, 2176), (2 ** 20, 2176),
    (16 * 2 ** 20, 2176), (4096, 16384),
]


def _chains(plan, npad):
    """The (start, stop) row ranges of K6's register chains, in the order
    csrc/scaled_matmul.cu walks them: split by split, chain_rows at a
    time from each split's first row."""
    out = []
    for k in range(plan.nsplit):
        lo, hi = k * plan.split_rows, min((k + 1) * plan.split_rows, npad)
        for a in range(lo, hi, plan.chain_rows):
            out.append((a, min(a + plan.chain_rows, hi)))
    return out


@pytest.mark.parametrize("npad,mpad", PLAN_SHAPES)
def test_gram_plan_covers_every_row_once_in_short_chains(npad, mpad):
    plan = tsm.gram_plan(npad, mpad)
    panels = mpad // 128
    assert plan.tiles == panels * (panels + 1) // 2
    assert plan.split_rows % tsm.GRAM_SLAB == 0
    assert plan.chain_rows % tsm.GRAM_SLAB == 0
    assert plan.chain_rows <= 16384
    assert (plan.nsplit - 1) * plan.split_rows < npad <= (
        plan.nsplit * plan.split_rows)
    chains = _chains(plan, npad)
    assert chains[0][0] == 0 and chains[-1][1] == npad
    assert all(a[1] == b[0] for a, b in zip(chains, chains[1:]))
    assert all(0 < hi - lo <= 16384 and (hi - lo) % tsm.GRAM_SLAB == 0
               for lo, hi in chains)


@pytest.mark.parametrize("mpad", [640, 2176])
def test_gram_scratch_does_not_grow_with_npad(mpad):
    """Past a few thousand rows a split the plan stops changing: the
    scratch is splits x tiles x 128^2 floats whatever npad is (it was
    ceil(npad / 16384) x mpad^2 floats: 105 MB at 1 MP, 4.6 GB at mpad
    2176 on 2000 x 2000 pixels)."""
    plans = [tsm.gram_plan(npad, mpad) for npad in
             (2 ** 20, 4 * 2 ** 20, 16 * 2 ** 20, 64 * 2 ** 20)]
    sizes = {p.scratch_bytes for p in plans}
    assert len(sizes) == 1
    assert {(p.tiles, p.nsplit) for p in plans} == {(plans[0].tiles,
                                                     plans[0].nsplit)}
    # At most GRAM_MAX_WAVES waves of blocks, and whole waves nearly full.
    blocks = plans[0].tiles * plans[0].nsplit
    waves = -(-blocks // tsm.GRAM_SLOTS)
    assert waves <= tsm.GRAM_MAX_WAVES
    assert blocks / (waves * tsm.GRAM_SLOTS) >= 0.95
    assert sizes.pop() <= 64 * 2 ** 20


def test_gram_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    """The plan, and with it the summation order, never reads the card:
    bitwise retraining must not depend on what the card is doing."""
    want = [tsm.gram_plan(*s) for s in PLAN_SHAPES]

    def refuse(*args, **kw):
        raise AssertionError("the plan queried the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    assert [tsm.gram_plan(*s) for s in PLAN_SHAPES] == want


@pytest.mark.parametrize("npad,mpad", [(2040, 128), (2048, 64), (0, 128)])
def test_gram_plan_refuses_shapes_the_kernel_cannot_take(npad, mpad):
    with pytest.raises(ValueError, match="K6 takes"):
        tsm.gram_plan(npad, mpad)


def _stage2b_inputs(layout):
    """A split-layout (rest block) or assembled-layout factor with k = 7
    eigenvectors at mb = 37, mpad 128, c zero on rows < m."""
    rng = np.random.default_rng(21)
    p, m, mb, k, n = 40, 30, 37, 7, 1500
    npad, mpad = 2048, 128
    phi = np.zeros((npad, mpad), np.float32)
    c = np.zeros((npad, 1), np.float32)
    if layout == "split":
        phi[:n - p, :mb] = rng.standard_normal((n - p, mb))
        c[:n - p, 0] = rng.random(n - p)
        va_grt = rng.standard_normal((p + mb, k)).astype(np.float32)
        grt = va_grt[p:]
        factor = (torch.from_numpy(phi),)
    else:
        phi[:n, :mb] = rng.standard_normal((n, mb))
        c[m:n, 0] = rng.random(n - m)
        va_grt = rng.standard_normal((mb, 2 * k)).astype(np.float32)
        grt = va_grt[:, k:]
        factor = torch.from_numpy(phi)
    return dict(factor=factor, c=torch.from_numpy(c),
                va_grt=torch.from_numpy(va_grt), n=n, mb=mb, p=p, k=k,
                phi=phi, c_np=c, grt=grt)


@pytest.mark.parametrize("layout", ["split", "assembled"])
def test_stage2b_at_the_narrow_width_matches_the_lane_width(monkeypatch,
                                                            layout):
    """K7's callers pad GrT to round_up(k, 32) columns (32 at k = 7; 64 at
    the main path's k = 50) where they padded to the TPU's 128 lanes: V is
    unchanged."""
    d = _stage2b_inputs(layout)
    assert tpipe.MATMUL_COL_ALIGN == 32
    seen = []
    real = tpipe.scaled_matmul

    def spy(phi, c, B):
        seen.append(B.shape[1])
        return real(phi, c, B)

    monkeypatch.setattr(tpipe, "scaled_matmul", spy)
    narrow = tpipe._stage2b_dense_body(d["factor"], d["c"], d["va_grt"],
                                       n=d["n"], mb=d["mb"], scaled=False)
    monkeypatch.setattr(tpipe, "MATMUL_COL_ALIGN", 128)
    wide = tpipe._stage2b_dense_body(d["factor"], d["c"], d["va_grt"],
                                     n=d["n"], mb=d["mb"], scaled=False)
    assert seen == [32, 128]
    assert narrow.shape == wide.shape == (d["n"], d["k"])
    # Each column is the same mpad-term product; only the BLAS blocking of
    # the two widths may differ: (2 mpad + 4) u of |c phi| |B|.
    cphi = np.abs(d["c_np"].astype(np.float64) * d["phi"])
    absv = cphi @ np.abs(np.pad(d["grt"], ((0, 128 - d["mb"]), (0, 0))))
    rows = slice(d["p"], d["n"]) if layout == "split" else slice(0, d["n"])
    bound = (2 * 128 + 4) * U * absv[:d["n"] - (d["p"] if layout == "split"
                                                 else 0)] + 1e-30
    diff = np.abs(narrow.numpy()[rows] - wide.numpy()[rows])
    assert np.all(diff <= bound)
    if layout == "split":
        assert torch.equal(narrow[:d["p"]], wide[:d["p"]])


@pytest.mark.parametrize("layout", ["split", "assembled"])
def test_stage2b_at_the_narrow_width_matches_interpreted_pallas(layout):
    """The narrow width's V against nle_tpu's scaled_matmul_pallas
    (interpret mode) on the 128-lane B the TPU path passes."""
    d = _stage2b_inputs(layout)
    got = tpipe._stage2b_dense_body(d["factor"], d["c"], d["va_grt"],
                                    n=d["n"], mb=d["mb"], scaled=False).numpy()
    B = np.zeros((128, 128), np.float32)
    B[:d["mb"], :d["k"]] = d["grt"]
    v = np.asarray(scaled_matmul_pallas(jnp.asarray(d["phi"]),
                                        jnp.asarray(d["c_np"]),
                                        jnp.asarray(B), interpret=True))
    va = d["va_grt"].numpy()
    if layout == "split":
        want = np.concatenate([va[:d["p"]], v[:d["n"] - d["p"], :d["k"]]])
        rows_b = slice(d["p"], d["n"])
    else:
        want = v[:d["n"], :d["k"]].copy()
        want[:d["mb"]] += va[:, :d["k"]]
        rows_b = slice(0, d["n"])
    cphi = np.abs(d["c_np"].astype(np.float64) * d["phi"])
    absv = cphi @ np.abs(B.astype(np.float64))
    nrows = rows_b.stop - rows_b.start
    bound = 2 * (128 + 2) * U * absv[:nrows, :d["k"]] + 1e-30
    if layout == "assembled":
        bound[:d["mb"]] += 4 * U * np.abs(va[:, :d["k"]])
    assert np.all(np.abs(got[rows_b] - want[rows_b]) <= bound)
    if layout == "split":
        assert np.array_equal(got[:d["p"]], want[:d["p"]])


@pytest.mark.parametrize("kpad", [16, 48, 100])
def test_scaled_matmul_refuses_widths_off_the_32_grid(kpad):
    phi, c = torch.zeros((64, 64)), torch.zeros((64, 1))
    with pytest.raises(ValueError, match="32k"):
        tsm.scaled_matmul(phi, c, torch.zeros((64, kpad)))


# -- on the card ---------------------------------------------------------------

def _factor(rng, npad, mpad, dev):
    """phi with a ragged zero tail of rows and columns, c in [0, 1) with
    every 7th row zero (excluded rows)."""
    n, m = npad - 40, mpad - 24
    phi = torch.zeros((npad, mpad), device=dev)
    phi[:n, :m] = torch.from_numpy(
        rng.standard_normal((n, m)).astype(np.float32) * 0.1 + 0.05).to(dev)
    c = torch.from_numpy(rng.random((npad, 1)).astype(np.float32)).to(dev)
    c[::7] = 0.0
    c[n:] = 0.0
    return phi, c


@pytest.mark.cuda
@pytest.mark.parametrize("npad,mpad", [(20544, 128), (600064, 640),
                                       (2 ** 17 + 64, 2176)])
def test_cuda_scaled_kernels_match_plain_versions(npad, mpad):
    """K6 and K7 against their plain versions on the card, with ragged
    split chunks (the last split shorter, chains of 2,048 rows and a
    remainder) and zeros in c: Sb within GRAM_SUM_TOL of |c phi|^T |c phi|
    from the float64 plain version,
    bitwise symmetric and bitwise repeatable; V within (2 mpad + 4) u of
    |c phi| |B| at every width the callers pass, bitwise repeatable."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(mpad)
    phi, c = _factor(rng, npad, mpad, dev)
    plan = tsm.gram_plan(npad, mpad)
    assert npad < plan.nsplit * plan.split_rows
    _build.reset_launches()
    g1 = tsm.scaled_gram(phi, c)
    g2 = tsm.scaled_gram(phi, c)
    torch.cuda.synchronize()
    assert torch.equal(g1, g2)
    assert torch.equal(g1, g1.T)
    # The plain version in float64: an fp32 cuBLAS gram sums each entry in
    # one long chain and drifts further than the kernel does.
    p64, c64 = phi.double(), c.double()
    gp = tsm.scaled_gram_plain(p64, c64)
    gabs = tsm.scaled_gram_plain(p64.abs(), c64.abs())
    assert bool(((g1.double() - gp).abs() <= GRAM_SUM_TOL * gabs).all())
    del gp, gabs, p64, c64
    for kpad in (32, 64, 128):
        B = torch.from_numpy(rng.standard_normal((mpad, kpad)).astype(
            np.float32) * 1e-2).to(dev)
        v1 = tsm.scaled_matmul(phi, c, B)
        v2 = tsm.scaled_matmul(phi, c, B)
        torch.cuda.synchronize()
        assert torch.equal(v1, v2)
        vp = tsm.scaled_matmul_plain(phi, c, B)
        vabs = tsm.scaled_matmul_plain(phi.abs(), c.abs(), B.abs())
        assert bool(((v1 - vp).abs() <= (2 * mpad + 4) * U * vabs
                     + 1e-30).all())
    assert _build.LAUNCHES["scaled_gram"] == 2
    assert _build.LAUNCHES["scaled_matmul"] == 6
