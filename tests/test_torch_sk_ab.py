"""The Sinkhorn A/B staging probes of the port (K15-K19, and the mxu
variant on K13) against the TPU kernels of tools/ themselves, on
numpy-made inputs.

The tools have no `interpret` argument and stay as they are: each is
loaded by path with jax.experimental.pallas.pallas_call patched to
interpret=True (every tool calls pl.pallas_call while it traces) and
NLE_JAX_CACHE_DIR=off (bench_sk_dmaonly starts no persistent cache), and
both are undone after this module. On the CPU the port's wrappers take
their plain twins; the CUDA kernels are held against those by
chip_smoke.py [10a]/[11] and the `cuda`-marked test at the end.

Tolerances: x (and K15 wonly's folded w) to rtol 1e-6, s to rtol 1e-5:
the two sides form the same products and sum ~10^2-10^4 of them in
different orders (measured 1e-7-2e-6). The staging probes' row 0 (K15
dmaonly, K19) is the same rows added in the same order: exact.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import sinkhorn_ab_kernel as ab
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsk

EPS = 1e-10
TOOLS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
# (npad, mpad): the tools' width and a narrow one, at two npad.
SHAPES = [(4096, 640), (8192, 128)]


def load_tools(names):
    """The named tools/ modules, loaded by path with pallas_call in
    interpret mode; returns ({name: module}, the MonkeyPatch to undo)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("NLE_JAX_CACHE_DIR", "off")
    mp.setattr(pl, "pallas_call",
               functools.partial(pl.pallas_call, interpret=True))
    mods = {}
    for name in names:
        spec = importlib.util.spec_from_file_location(
            f"tools_{name}", os.path.join(TOOLS_DIR, f"{name}.py"))
        mods[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mods[name])
    return mods, mp


@pytest.fixture(scope="module")
def tools():
    mods, mp = load_tools(["bench_sk_unroll", "bench_sk_variants",
                           "bench_sk_2stream", "bench_sk_dmaonly"])
    yield mods
    mp.undo()


def factor(npad, mpad, seed, offset=0.1):
    """The tools' inputs: phi normal x 0.05 (+ offset), t uniform."""
    rng = np.random.default_rng(seed)
    phi = (rng.standard_normal((npad, mpad)) * 0.05 + offset).astype(
        np.float32)
    return phi, rng.random(mpad).astype(np.float32)


def both(phi, t):
    return (jnp.asarray(phi), jnp.asarray(t), torch.from_numpy(phi),
            torch.from_numpy(t))


def assert_halfstep(got, want, exact_zero_s=False):
    x, s = (v.numpy() for v in got)
    xj, sj = (np.asarray(v) for v in want)
    np.testing.assert_allclose(x, xj, rtol=1e-6)
    if exact_zero_s:
        np.testing.assert_array_equal(s, 0.0)
        np.testing.assert_array_equal(sj, 0.0)
    else:
        np.testing.assert_allclose(s, sj, rtol=1e-5)


# -- K16 -----------------------------------------------------------------------

@pytest.mark.parametrize("npad,mpad", SHAPES)
@pytest.mark.parametrize("chunk", [512, 1024])
def test_k16_unroll_matches_interpreted_kernel(tools, npad, mpad, chunk):
    """K16's twin against `_kernel_unroll` (tools/bench_sk_unroll.py:20):
    chunk a's partial to stripe a % 8, the stripes summed."""
    P, T, Pt, Tt = both(*factor(npad, mpad, seed=21))
    want = tools["bench_sk_unroll"].halfstep_unroll(P, T, EPS, chunk=chunk)
    assert_halfstep(ab.sinkhorn_unroll(Pt, Tt, EPS, chunk), want)


# -- K17 / K18 / K13 ---------------------------------------------------------

@pytest.mark.parametrize("npad,mpad", SHAPES)
@pytest.mark.parametrize("tile", [1024, 2048])
@pytest.mark.parametrize("variant", ["parts3d", "mxu", "vpu", "mxu_row0",
                                     "xonly"])
def test_variants_match_interpreted_kernels(tools, variant, tile, npad,
                                            mpad):
    """Each variant of tools/bench_sk_variants.py (parts3d :89, mxu :18,
    vpu :38, mxu_row0 :55, xonly :74) against its twin; mxu is K13's
    function at rows = tile, bit for bit."""
    P, T, Pt, Tt = both(*factor(npad, mpad, seed=22))
    want = tools["bench_sk_variants"].make_halfstep(variant, tile, npad,
                                                    mpad)(P, T, EPS)
    got = ab.sinkhorn_variant(Pt, Tt, EPS, variant, tile)
    assert_halfstep(got, want, exact_zero_s=variant == "xonly")
    if variant == "mxu" and mpad % 128 == 0:
        for a, b in zip(got, tsk.sinkhorn_halfstep_tiled(Pt, Tt, EPS, tile)):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- K19 -----------------------------------------------------------------------

@pytest.mark.parametrize("npad,mpad", SHAPES)
@pytest.mark.parametrize("chunk", [1024, 2048])
@pytest.mark.parametrize("nstreams", [1, 2, 4])
def test_k19_2stream_matches_interpreted_probe(tools, nstreams, chunk, npad,
                                               mpad):
    """K19's twin against the probe of tools/bench_sk_2stream.py:21: row 0
    is the chunks' first rows added in order, exactly; rows 1-7 are 0."""
    P, T, Pt, Tt = both(*factor(npad, mpad, seed=23, offset=0.0))
    want = np.asarray(tools["bench_sk_2stream"].make(nstreams, chunk, npad,
                                                     mpad)(P, T))
    got = ab.sinkhorn_2stream(Pt, Tt, nstreams, chunk).numpy()
    assert got.shape == want.shape == (8, mpad)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1:], 0.0)


# -- K15 -----------------------------------------------------------------------

@pytest.mark.parametrize("npad,mpad", SHAPES)
@pytest.mark.parametrize("chunk", [512, 1024])
@pytest.mark.parametrize("variant", ["dmaonly", "wonly", "wpart"])
def test_k15_probe_matches_interpreted_probe(tools, variant, chunk, npad,
                                             mpad):
    """K15's twin returns the TPU probe's (8, max(mpad, chunk)) block
    (tools/bench_sk_dmaonly.py:37-62): dmaonly exactly, wonly's folded w
    to 1e-6, wpart to 1e-5. Where the probe does not trace (wonly at chunk
    512, mpad 640), the port raises ValueError."""
    P, T, Pt, Tt = both(*factor(npad, mpad, seed=24))
    run = tools["bench_sk_dmaonly"].make(variant, chunk, npad, mpad)
    try:
        want = np.asarray(run(P, T))
    except TypeError as err:       # the TPU probe fails to trace
        assert "incompatible shapes" in str(err)
        with pytest.raises(ValueError, match="does not trace"):
            tsk.sinkhorn_probe(Pt, Tt, variant, chunk)
        return
    got = tsk.sinkhorn_probe(Pt, Tt, variant, chunk).numpy()
    assert got.shape == want.shape == (8, max(mpad, chunk))
    if variant == "dmaonly":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want,
                                   rtol=1e-6 if variant == "wonly" else 1e-5,
                                   atol=0)
    np.testing.assert_array_equal(got[1:], 0.0)


# -- the shape rules -----------------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda P, T: ab.sinkhorn_unroll(P, T, EPS, 1024),    # npad % 2048
    lambda P, T: ab.sinkhorn_unroll(P, T, EPS, 0),
    lambda P, T: ab.sinkhorn_variant(P, T, EPS, "vpu", 2048),  # npad % tile
    lambda P, T: ab.sinkhorn_variant(P, T, EPS, "mxu", 4096),
    lambda P, T: ab.sinkhorn_variant(P, T, EPS, "mxu_row1", 1024),
    lambda P, T: ab.sinkhorn_2stream(P, T, 2, 2048),     # npad % chunk
    lambda P, T: ab.sinkhorn_2stream(P, T, 4, 1022),     # chunk % nstreams
    lambda P, T: tsk.sinkhorn_probe(P, T, "dmaonly", 2048),  # npad % chunk
    lambda P, T: tsk.sinkhorn_probe(P, T, "dma", 1024),
], ids=["unroll-npad", "unroll-chunk0", "vpu-npad", "mxu-npad",
        "variant-name", "2stream-npad", "2stream-nstreams", "probe-npad",
        "probe-name"])
def test_shape_rules_raise(call):
    """Every shape where the TPU kernel drops rows or does not trace
    raises ValueError (npad 3072, mpad 640)."""
    P, T = (torch.from_numpy(a) for a in factor(3072, 640, seed=25))
    with pytest.raises(ValueError):
        call(P, T)


@pytest.mark.parametrize("mpad,chunk,raises", [(640, 512, True),
                                               (512, 512, False),
                                               (640, 1024, False),
                                               (2176, 2048, False)])
def test_k15_wonly_width_rule(mpad, chunk, raises):
    """wonly traces on the TPU only where min(1024, max(mpad, chunk)) ==
    min(1024, chunk); the rule is the port's, on every device."""
    P, T = (torch.from_numpy(a) for a in factor(4096, mpad, seed=26))
    if raises:
        with pytest.raises(ValueError, match="does not trace"):
            tsk.sinkhorn_probe(P, T, "wonly", chunk)
    else:
        assert tsk.sinkhorn_probe(P, T, "wonly", chunk).shape == (
            8, max(mpad, chunk))


def test_operand_checks():
    """dtype, shape and device mix are checked before any dispatch."""
    P, T = (torch.from_numpy(a) for a in factor(4096, 128, seed=27))
    with pytest.raises(TypeError):
        ab.sinkhorn_unroll(P.double(), T, EPS, 1024)
    with pytest.raises(ValueError):
        ab.sinkhorn_variant(P, T[:64], EPS, "vpu", 1024)
    with pytest.raises(ValueError):
        ab.sinkhorn_2stream(P[0], T, 1, 1024)
    with pytest.raises(ValueError, match="one CUDA device"):
        ab.sinkhorn_unroll(P, T.to("meta"), EPS, 1024)


def test_ring_rules():
    """K16's ring holds four 16-row slots at the tools' mpad 640 (164 KB),
    fewer rows when wider; K19's two 32-row slots, fewer rows where the
    chunk or the streams ask."""
    assert ab.unroll_rows(640) == ab.unroll_rows(128) == 16
    assert 4 * 16 * 640 * 4 == 163_840
    assert ab.unroll_rows(2176) == 5 and ab.unroll_rows(8192) == 0
    assert ab.stream_rows(640, 1024, 4) == ab.stream_rows(640, 2048, 1) == 32
    assert ab.stream_rows(640, 24, 1) == 8
    assert ab.stream_rows(640, 24, 4) == 8
    assert ab.stream_rows(640, 6, 4) == 0


# -- the tools refuse the CPU --------------------------------------------------

@pytest.mark.parametrize("tool,table", [
    ("bench_sk_unroll", "unroll_table"),
    ("bench_sk_variants", "variants_table"),
    ("bench_sk_2stream", "stream_table"),
])
def test_tools_measure_only_the_card(tool, table):
    """Each port tool reports device times: without a card it prints why
    and returns 2, and its table function raises RuntimeError."""
    mod = importlib.import_module(f"nle_tpu_torch.tools.{tool}")
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py [11] runs the tools")
    assert mod.main([]) == 2
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(mod, table)(torch, 4096, 128)


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_ab_kernels_match_plain_versions():
    """K15-K19 and the mxu variant on K13 against their plain twins on the
    card, each launch counted once under its own name."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    phi, t = factor(8192, 640, seed=28)
    P, T = torch.from_numpy(phi).to(dev), torch.from_numpy(t).to(dev)
    _build.reset_launches()
    pairs = [(ab.sinkhorn_unroll(P, T, EPS, c),
              ab.sinkhorn_unroll_plain(P, T, EPS, c)) for c in (512, 1024)]
    pairs += [(ab.sinkhorn_variant(P, T, EPS, v, 2048),
               ab.sinkhorn_variant_plain(P, T, EPS, v, 2048))
              for v in ab.VARIANTS]
    for got, want in pairs:
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for ns in (1, 2, 4):
        torch.testing.assert_close(ab.sinkhorn_2stream(P, T, ns, 1024),
                                   ab.sinkhorn_2stream_plain(P, T, ns, 1024),
                                   rtol=0, atol=0)
    for variant in tsk.PROBE_VARIANTS:
        got = tsk.sinkhorn_probe(P, T, variant, 1024)
        want = tsk.sinkhorn_probe_plain(P, T, variant, 1024)
        torch.testing.assert_close(got, want, atol=0,
                                   rtol=0 if variant == "dmaonly" else 1e-5)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "sinkhorn_ab_unroll": 2, "sinkhorn_ab_parts3d": 1,
        "sinkhorn_ab_mxu_row0": 1, "sinkhorn_ab_vpu": 1,
        "sinkhorn_ab_xonly": 1, "sinkhorn_halfstep_tiled": 1,
        "sinkhorn_ab_2stream": 3, "sinkhorn_probe_dmaonly": 1,
        "sinkhorn_probe_wonly": 1, "sinkhorn_probe_wpart": 1}
