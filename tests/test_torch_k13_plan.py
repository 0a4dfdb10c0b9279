"""K13's launch plan (sinkhorn_kernel.k13_plan) on the shapes that occur:
the 1 MP assembled factor, mpad 2176 on 2^20 rows, the mxu variant's
tiles, and every tile from 256 to 2048 at widths from 128 to MAX_MPAD.
The plan is a function of the shapes alone; the kernel's C entry refuses
any plan that does not cover every tile once in whole sub-tiles, so these
checks are what keeps a launch from being refused. The kernel itself is
held bit for bit to its earlier sweep on the card (chip_smoke.py [9d],
[10a], [11] and the cuda test of test_torch_sinkhorn_modes.py)."""

import pytest

from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsk
from nle_tpu_torch.ops.kernels._common import SHARED_LIMIT

# Shared memory of one H100 SM and what the card reserves for each block:
# two CTAs fit an SM when 2 (shared + reserve) <= SM_SHARED.
SM_SHARED = 233_472
BLOCK_RESERVE = 1024

# (npad, mpad, tile): chip_smoke's [10a] and [11] (1 MP, tiles 1024 and
# 2048) and [9d] (2^20 rows at mpad 2176, k13_tile's 512).
PATH_SHAPES = [(1_011_712, 640, 1024), (1_011_712, 640, 2048),
               (1 << 20, 2176, 512)]
WIDTHS = (128, 384, 640, 1024, 2176, 4096, 8192, 16384)
TILES = (256, 512, 1024, 2048)


def _check(npad: int, mpad: int, tile: int):
    plan = tsk.k13_plan(npad, mpad, tile)
    rows, slots, ctas, per_cta, shared = plan
    ntiles = npad // tile
    # Every tile lies whole inside one CTA's run; every row once.
    runs = [range(b * per_cta, min((b + 1) * per_cta, ntiles))
            for b in range(ctas)]
    assert all(len(r) > 0 for r in runs)
    assert [k for r in runs for k in r] == list(range(ntiles))
    assert ctas <= tsk.SK_CTAS
    # Sub-tiles: whole rows of a 16-byte multiple, dividing the tile.
    assert 1 <= rows <= tsk.SK_MAX_ROWS and tile % rows == 0
    assert (4 * mpad) % 16 == 0 and (rows * 4 * mpad) % 16 == 0
    assert 2 <= slots <= tsk.SK_MAX_SLOTS
    assert shared == 128 + slots * rows * 4 * mpad + 4 * (
        mpad + 2 * tsk.SK_MAX_ROWS)
    assert shared <= SHARED_LIMIT
    if mpad <= 2176:
        assert 2 * (shared + BLOCK_RESERVE) <= SM_SHARED
    return plan


@pytest.mark.parametrize("npad,mpad,tile", PATH_SHAPES)
def test_k13_plan_on_the_path_shapes(npad, mpad, tile):
    plan = _check(npad, mpad, tile)
    # The staging chosen on the card (nle_tpu_torch/tools/k13_plans.py):
    # K4's sub-tiles and ring, every CTA a run of whole tiles.
    want = {(1_011_712, 640, 1024): (16, 2, 247, 4),
            (1_011_712, 640, 2048): (16, 2, 247, 2),
            (1 << 20, 2176, 512): (4, 2, 256, 8)}[(npad, mpad, tile)]
    assert plan[:4] == want


@pytest.mark.parametrize("mpad", WIDTHS)
@pytest.mark.parametrize("tile", TILES)
def test_k13_plan_every_tile_and_width(mpad, tile):
    for npad in (tile, 3 * tile, 1 << 20, 1_011_712):
        if npad % tile == 0:
            _check(npad, mpad, tile)


@pytest.mark.parametrize("mpad", WIDTHS)
def test_k13_plan_at_the_loop_tile(mpad):
    """sinkhorn_vectors_fused's tile: k13_tile halves 1024 for wide
    factors."""
    tile = tsk.k13_tile(mpad)
    _check(tsk.round_up(1_000_000, tile), mpad, tile)


@pytest.mark.parametrize("npad,mpad,tile,what", [
    (1_011_712, 640, 1000, "multiple"),     # a tile that drops rows
    (4096, 640, 0, "multiple"),
    (0, 640, 1024, "16-byte"),
    (4096, 130, 1024, "16-byte"),           # 520-byte rows
    (4096, 20480, 256, "shared memory"),    # the ring and s row too wide
])
def test_k13_plan_refuses_what_the_kernel_cannot_take(npad, mpad, tile,
                                                     what):
    with pytest.raises(ValueError, match=what):
        tsk.k13_plan(npad, mpad, tile)


def test_k13_plans_tool_needs_a_card():
    """The tool that times K13's plans measures the card: without one it
    returns 2 and prints nothing of a result."""
    import torch

    from nle_tpu_torch.tools import k13_plans

    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool measures it instead")
    assert k13_plans.main() == 2
