"""The affinity core's plan (K1, K2's contract and K12's phi step share
csrc/affinity_core.cuh) and K15's plan on the half-step's bulk-copy sweep,
on the CPU: every column covered once in panels of at most 384, a
function of the shapes alone, csrc's constants equal to the Python
mirror, the wrappers' launches against a stand-in for the kernel
library. The kernels themselves are held to their plain versions on the
card by chip_smoke.py."""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import affinity_kernel as tak
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsink

CSRC = os.path.join(os.path.dirname(tak.__file__), "..", "..", "csrc")
SMEM_LIMIT = 232448            # a Hopper block's shared memory, bytes
MPADS = (128, 640, 1280, 1792, 2176)
# (Qpad, Ppad): the 1 MP split rows at p = 600 and p = 1200, the 16 MP
# dense grid, and small ones.
SHAPES = ((1011712, 608), (1011712, 1200), (15998464, 2176), (64, 16),
          (4096, 640))
NPAD_1MP = 1011712             # the 1 MP assembled factor, mpad 640


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


@pytest.mark.parametrize("mpad", MPADS)
@pytest.mark.parametrize("qpad,ppad", SHAPES)
def test_affinity_plan_covers_every_column_once(qpad, ppad, mpad):
    """Full 384-column panels, then one of the remaining 128 or 256: each
    column of Mpad in exactly one panel of at most 384 (so each entry is
    built once a panel: once up to 384, twice at 640, four times at
    1280), every panel a TN = 12, 8 or 4 instantiation, the rows a whole
    number of blocks and the shared memory within a block."""
    plan = tak.affinity_plan(qpad, ppad, mpad)
    edges = np.cumsum((0,) + plan.panels)
    seen = np.zeros(mpad, np.int64)
    for a, b in zip(edges[:-1], edges[1:]):
        seen[a:b] += 1
    assert (seen == 1).all()
    assert all(w in (128, 256, 384) for w in plan.panels)
    assert list(plan.panels) == sorted(plan.panels, reverse=True)
    assert len(plan.panels) == -(-mpad // tak.AFF_PANEL_COLS)
    assert qpad % plan.rows == 0 and plan.threads == 4 * plan.rows
    assert plan.shared_bytes <= SMEM_LIMIT
    assert (plan.rows, plan.stages) == (tak.AFF_ROWS, tak.AFF_STAGES)


def test_affinity_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    want = {(s, m): tak.affinity_plan(*s, m) for s in SHAPES for m in MPADS}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_name", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {(s, m): tak.affinity_plan(*s, m) for s, m in want} == want


@pytest.mark.parametrize("qpad,ppad,mpad", [
    (100, 640, 640), (64, 600, 640), (64, 640, 200), (64, 640, 0),
    (64, 0, 640), (96, 640, 640)])
def test_affinity_plan_raises_on_shapes_the_core_cannot_take(qpad, ppad,
                                                            mpad):
    with pytest.raises(ValueError):
        tak.affinity_plan(qpad, ppad, mpad)


def test_affinity_core_mirrors_the_kernel_source():
    """csrc/affinity_core.cuh's constants are the plan's; K1's old 64 x 64
    x 16 tile is gone from common.cuh; K12's phi step calls the core's C
    entry."""
    core = _read("affinity_core.cuh")
    assert _const(core, "AC_K") == tak.AFF_K == tak.P_TILE
    assert _const(core, "AC_MAX_COLS") == tak.AFF_PANEL_COLS
    assert _const(core, "AC_BUILD") == tak.AFF_BUILD
    assert _const(core, "AC_ROWS") == tak.AFF_ROWS == tak.ROW_TILE
    assert _const(core, "AC_STAGES") == tak.AFF_STAGES
    assert "gemm_tile" not in _read("common.cuh")
    assert '#include "affinity_core.cuh"' in _read("affinity.cu")
    assert "nle_affinity_matmul(" in _read("streaming.cu")


# -- the launches, against a stand-in library ---------------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("nle_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0

        return fn


@pytest.fixture()
def fake_card(monkeypatch):
    lib = _FakeLib()
    for mod in (tak, tsink):
        monkeypatch.setattr(mod, "cuda_or_cpu", lambda *a, **k: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    _build.reset_launches()
    yield lib
    _build.reset_launches()


def test_k1_launch_reads_the_plan(fake_card):
    """K1's C entry gets the padded shapes, the whole padded row range (r0
    0, rows Qpad) and the true row count for the zero tail; one launch,
    counted as affinity_matmul."""
    p, q, m, out_rows = 600, 1000, 591, 1024
    out = tak.affinity_matmul_kernel(
        torch.zeros((p, 3)), torch.zeros((q, 3)), torch.zeros((p, m)), 0.1,
        0.2, out_rows=out_rows)
    [(name, args)] = fake_card.calls
    assert name == "nle_affinity_matmul"
    assert args[4:10] == (out_rows, 608, 640, 0, out_rows, q)
    assert args[10:12] == (0.1, 0.2)
    assert out.shape == (out_rows, 640)
    assert _build.LAUNCHES["affinity_matmul"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


@pytest.mark.parametrize("chunk", (512, 1024))
def test_probe_plan_gives_each_cta_whole_chunks(chunk):
    """K15 on the bulk sweep at the 1 MP assembled shape: each CTA's row
    range is a whole number of chunks (so each chunk's partial is formed
    inside one CTA and the chunks add in order), the chunk whole sub-tiles,
    every row covered once; at most the half-step's 264 CTAs; the rest of
    the plan is the half-step's."""
    plan = tsink.sinkhorn_plan(NPAD_1MP, 640, torch.float32, chunk)
    half = tsink.sinkhorn_plan(NPAD_1MP, 640, torch.float32)
    assert plan.per_cta % chunk == 0 and chunk % plan.rows == 0
    begins = np.arange(plan.ctas) * plan.per_cta
    ends = np.minimum(begins + plan.per_cta, NPAD_1MP)
    assert begins[0] == 0 and ends[-1] == NPAD_1MP
    assert ((ends - begins) % chunk == 0).all() and (ends > begins).all()
    assert plan.ctas <= tsink.SK_CTAS
    assert (plan.rows, plan.slots, plan.shared_bytes) == (
        half.rows, half.slots, half.shared_bytes)


def test_probe_launch_reads_the_plan(fake_card):
    """K15's C entry gets the chunk, the mode and sinkhorn_plan's numbers
    for that chunk; a (npad / chunk, mpad) partial scratch; one launch."""
    npad, mpad, chunk = 8192, 640, 1024
    phi = torch.zeros((npad, mpad))
    out = tsink.sinkhorn_probe(phi, torch.zeros(mpad), "wpart", chunk)
    plan = tsink.sinkhorn_plan(npad, mpad, torch.float32, chunk)
    [(name, args)] = fake_card.calls
    assert name == "nle_sinkhorn_probe_f32"
    assert args[5:] == (npad, mpad, chunk, 3, *plan, None)
    assert out.shape == (8, max(mpad, chunk))
    assert _build.LAUNCHES["sinkhorn_probe_wpart"] == 1
