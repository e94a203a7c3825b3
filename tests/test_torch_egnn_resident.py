"""The host side of K1's edge kernel (``csrc/egnn_message.cu``): the plan
``ops.edge.resident_plan`` that splits the message weights over a cluster of
blocks by output columns and picks the edge tile, and the shared memory it
mirrors from the kernel's layout.  No card needed: the kernel itself is held
against its plain version, and its C twin of the plan against this one, by
``chip_smoke.py`` (phase 3) and ``tests/test_torch_cuda.py``."""

import pytest

from geometric_message_passing_tpu_torch.ops import edge

WIDTHS = range(16, 257, 16)
# the smallest cluster whose share of the weights fits a block beside an
# 8-row tile
CLUSTER = {**{d: 1 for d in range(16, 97, 16)}, 112: 2, 128: 2, 144: 2,
           160: 4, 176: 4, 192: 4, 208: 4, 224: 8, 240: 8, 256: 8}


@pytest.mark.parametrize("d", WIDTHS)
def test_plan_splits_the_weights_over_the_smallest_cluster_that_fits(d):
    """Every width the wrapper takes has a plan: shares of a multiple of 4
    columns (at most 128) summing to D, larger first and at most 4 apart,
    in a block that fits 227 KB at the plan's tile; no smaller cluster
    fits."""
    plan = edge.resident_plan(d, 1408, 66)
    assert plan.cluster == CLUSTER[d] and plan.cluster in edge.CLUSTERS
    assert len(plan.shares) == plan.cluster and sum(plan.shares) == d
    assert all(s % 4 == 0 and 4 <= s <= 128 for s in plan.shares)
    assert list(plan.shares) == sorted(plan.shares, reverse=True)
    assert plan.shares[0] - plan.shares[-1] <= 4
    assert plan.smem_bytes == edge.resident_smem_bytes(d, plan.shares[0], plan.tile)
    assert plan.smem_bytes <= edge.SMEM_MAX == 227 * 1024
    if plan.cluster > 1:
        smaller = edge.resident_shares(d, plan.cluster // 2)
        assert (smaller[0] > 128 or edge.resident_smem_bytes(
            d, smaller[0], 8) > edge.SMEM_MAX)


def test_plan_at_the_main_width():
    """D 128: two blocks of 64 columns, each holding 519 weight rows (in 17
    boxes of 32) of 64 floats and the vector rows whole, beside the tile's
    rows (x, two buffers of whole product rows, two of row scalars)."""
    plan = edge.resident_plan(128, 129_280, 66)
    assert plan == (2, (64, 64), 40, 4 * (32 + 544 * 64 + 10 * 128
                                          + 40 * (260 + 2 * 132 + 2 * 12)))


@pytest.mark.parametrize("d,shares", [
    (240, (32, 32, 32, 32, 28, 28, 28, 28)),   # not a multiple of 4 x 8
    (208, (52, 52, 52, 52)),
    (176, (44, 44, 44, 44)), (144, (72, 72)), (16, (16,))])
def test_uneven_widths_deal_float4_columns(d, shares):
    assert edge.resident_shares(d, len(shares)) == shares


@pytest.mark.parametrize("n_edges,clusters,tile", [
    (0, 66, 8), (5, 66, 8), (400, 66, 8),   # no edges, below one tile, few
    (1400, 66, 24), (1408, 66, 24),         # star train and serving buckets
    (4193, 66, 32), (129_280, 66, 40),      # 132 tiles of 32; the 10k box
    (1408, 132, 16), (4193, 132, 32)])      # more clusters
def test_tile_takes_the_fewest_rounds_of_rows(n_edges, clusters, tile):
    """At D 128 on ``clusters`` clusters: the tile with the fewest rounds x
    (rows + 16), the smaller on a tie."""
    assert edge.resident_plan(128, n_edges, clusters).tile == tile
    rounds = {t: -(-(-(-n_edges // t)) // clusters) for t in edge.RESIDENT_TILES}
    cost = {t: rounds[t] * (t + 16) for t in edge.RESIDENT_TILES}
    assert cost[tile] == min(cost.values())
    assert all(cost[t] > cost[tile] for t in edge.RESIDENT_TILES if t < tile)


@pytest.mark.parametrize("d,tiles", [(208, (8,)), (144, (8, 16)), (256, (8, 16)),
                                     (176, (8, 16, 24)), (128, (8, 16, 24, 32, 40))])
def test_tile_only_where_it_fits(d, tiles):
    """A tile whose block would not fit is never taken, even on the box."""
    assert edge.resident_plan(d, 129_280, 66).tile == tiles[-1]
    for t in edge.RESIDENT_TILES:
        fits = edge.resident_smem_bytes(d, edge.resident_shares(
            d, CLUSTER[d])[0], t) <= edge.SMEM_MAX
        assert fits == (t in tiles)


@pytest.mark.parametrize("d", [0, 8, 24, 100, 272, 512])
def test_width_without_a_plan_raises(d):
    with pytest.raises(ValueError, match="multiple of 16"):
        edge.resident_plan(d, 1408, 66)
