"""The launch plan of the pull kernel (`csrc/bottomup.cu`, which both pull
wrappers launch): pure Python, so it is checked here on the CPU.

The tests walk the kernel's own loops over the plan (blocks striding over
tiles of rows x lanes, one thread a row in tier 1) with numpy and count how
often each (lane, row) is reached: exactly once, for B in {1, 8, 16} and
others, row counts from 1 to the base bucket of RMAT scale 22, on an
H100's 132 SMs at several blocks per SM. A row's first slots take one
thread (a group that divides any warp), its deep ones a warp, then the
block. The plan does not depend on W: the tiers' ends are checked against
the ELL ladder's widths instead.
"""
import numpy as np
import pytest

from repro_torch.kernels import bottomup as tbu

H100_SMS = 132
LADDER = [32 << k for k in range(14)]            # 32 .. 262,144
RESIDENT = (1, 3, 8)
V = 4194304                                      # RMAT scale 22
ROWS = (1, 4, 6, 60, 257, 3000, 74582)


def _cover(plan, b, r):
    """[B, R] counts of the (lane, row) pairs the kernel's tiles reach:
    block k takes tiles k, k + blocks, ...; tile t is row block t //
    lane_tiles and lane block t % lane_tiles; thread i < rows takes row i
    of the row block, for each lane j < lanes of the lane block."""
    rows, lanes, blocks = plan["rows"], plan["lanes"], plan["blocks"]
    lane_tiles = -(-b // lanes)
    tiles = -(-r // rows) * lane_tiles
    count = np.zeros((b, r), np.int64)
    for blk in range(blocks):
        t = np.arange(blk, tiles, blocks)
        row = (t // lane_tiles * rows)[:, None] + np.arange(rows)[None]
        lane = (t % lane_tiles * lanes)[:, None] + np.arange(lanes)[None]
        ok_r, ok_l = row < r, lane < b
        for i in range(len(t)):
            count[np.ix_(lane[i][ok_l[i]], row[i][ok_r[i]])] += 1
    return count


@pytest.mark.parametrize("b", [1, 3, 8, 16, 32])
def test_pull_plan_covers_every_lane_and_row_once(b):
    for r in ROWS:
        for resident in RESIDENT:
            plan = tbu.pull_plan(b, r, V, H100_SMS, resident)
            assert plan["lanes_block"] == tbu.lane_block(b) in (1, 8, 16)
            assert 1 <= plan["lanes"] <= plan["lanes_block"]
            assert 1 <= plan["rows"] <= tbu.THREADS
            assert plan["rows"] & (plan["rows"] - 1) == 0
            # as many blocks as the SMs hold, unless there are fewer
            # (lane, row) pairs than that: each then has a tile
            assert plan["blocks"] == min(H100_SMS * resident, r * b)
            assert (_cover(plan, b, r) == 1).all(), (b, r, resident)
            # packed words hold whole lane blocks
            assert not plan["packed"] or (
                b > 1 and plan["lanes"] == plan["lanes_block"])
            assert tbu.pull_plan(b, r, V, H100_SMS, resident) == plan


def test_pull_plan_reads_a_rows_ids_once_while_rows_fill_the_card():
    """The base bucket (1,977,973 rows, 1, 8 or 16 lanes): 256 rows a
    tile, one a thread, with all of a row's lanes, so its first ids are
    read once for all of them, and the frontier packed into lane words (8
    or 16 lanes); the base hub bucket (74,582 rows) the same with 128 rows
    a tile, so that the tiles fill the card, and unpacked (too few rows to
    pay for reading the whole frontier once more). Few wide
    rows: rows shrink first, then lanes, until the tiles reach the blocks
    the SMs hold (the scale-22 split's widest bucket: 6 rows)."""
    for b, r in ((8, 1977973), (16, 1977973), (1, 1977973)):
        plan = tbu.pull_plan(b, r, V, H100_SMS, 4)
        assert (plan["rows"], plan["lanes"]) == (tbu.THREADS, tbu.lane_block(b))
        assert plan["blocks"] == H100_SMS * 4
        assert plan["packed"] == (b > 1)     # one gather for all lanes
    # 292 tiles of 256 rows would leave blocks idle: 583 of 128
    assert tbu.pull_plan(8, 74582, V, H100_SMS, 4) == dict(
        rows=128, lanes=8, lanes_block=8, thread_slots=36, warp_slots=292,
        packed=False, blocks=H100_SMS * 4)
    plan = tbu.pull_plan(8, 3000, V, H100_SMS, 8)
    assert plan["lanes"] == 8 and plan["rows"] < tbu.THREADS
    plan = tbu.pull_plan(8, 6, V, H100_SMS, 8)
    assert (plan["rows"], plan["lanes"], plan["blocks"]) == (1, 1, 48)
    assert tbu.pull_plan(1, 4, V, H100_SMS, 8)["blocks"] == 4


@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("w", LADDER + [33, 40, 96, 300])
def test_pull_tiers_cover_every_width(b, w):
    """Tier 1 takes FIRST slots, tier 2 (a thread a row) runs in DEEP-slot
    steps to thread_slots, which holds a whole row of the base bucket (32
    slots), tier 3 (a warp a pair, 128 slots a step) to warp_slots, which
    holds a whole 256-slot hub row, tier 4 (the block) the rest: the tiers'
    ends fit the source's checks (tier 2 and 3 end on a step's edge) and
    split every width into its tiers."""
    plan = tbu.pull_plan(b, 1000, V, H100_SMS, 4)
    first, deep = tbu.FIRST, tbu.DEEP[plan["lanes_block"]]
    ts, ws = plan["thread_slots"], plan["warp_slots"]
    assert first % 4 == 0 and deep % 4 == 0
    assert ts >= max(first, 32) and (ts - first) % deep == 0
    assert ws >= 256 and (ws - ts) % tbu.CHUNK == 0
    tiers = [min(w, first), min(w, ts) - min(w, first),
             min(w, ws) - min(w, ts), w - min(w, ws)]
    assert sum(tiers) == w and min(tiers) >= 0
    assert tiers[3] == 0 or w > 256
