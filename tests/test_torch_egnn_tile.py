"""The host side of the EGNN kernels' tiles (K2's edge kernel and K6): the
tile rule ``ops.edge.egnn_tile``, the shared-memory size mirrored from
``csrc/egnn_common.cuh::tile_layout``, the row strides, the kept forward
activations' layouts and the scratch the wrappers hand the kernels.  No
card needed: the kernels themselves are held against their plain versions
by ``chip_smoke.py`` (phases 3 and 3c) and ``tests/test_torch_cuda.py``."""

import pytest
import torch

from geometric_message_passing_tpu_torch.ops import edge
from geometric_message_passing_tpu_torch.ops import egnn_stack as es


@pytest.mark.parametrize("n_edges,tile", [
    (0, 8), (1, 8), (5, 8),              # no edges, below one tile
    (1400, 8),                           # the star train bucket: 175 tiles
    (1408, 8),                           # the serving bucket
    (16 * 131, 8), (16 * 131 + 1, 16),   # where 16-row tiles cover the SMs
    (32 * 131, 16), (32 * 131 + 1, 32),  # where 32-row tiles do
    (4241, 32),                          # not a multiple of the tile
    (129_224, 32), (129_280, 32)])       # the unsorted 10k box (live, bucket)
def test_tile_rule(n_edges, tile):
    """The tile on 132 SMs: the largest of 8, 16 and 32 that still gives
    every SM an edge tile."""
    assert edge.egnn_tile(n_edges, 132) == tile
    assert -(-n_edges // tile) >= 132 or tile == 8


def test_tile_rule_takes_only_tiles_that_fit():
    """A tile whose shared memory does not fit is skipped; with none
    fitting the tile is 8; fewer SMs move the thresholds."""
    assert edge.egnn_tile(129_224, 132, fits=lambda t: t <= 16) == 16
    assert edge.egnn_tile(129_224, 132, fits=lambda t: False) == 8
    assert edge.egnn_tile(129_224, 114) == 32
    assert edge.egnn_tile(2000, 114) == 16


@pytest.mark.parametrize("n", [1, 3, 16, 31, 32, 33, 128, 129, 256, 257, 513])
def test_row_stride_is_4_mod_32_and_holds_the_row(n):
    """A tile row of n floats gets a stride of 4 mod 32 (four consecutive
    rows read as float4 fall on distinct banks), at least n and less than
    n + 36."""
    ld = edge._row_ld(n)
    assert ld % 32 == 4 and n <= ld < n + 36


@pytest.mark.parametrize("tile,d,floats", [
    # the head (4 mbarriers, two counts: 16 floats), x rows [tile,
    # row_ld(2d+1)], two rows [tile, row_ld(d)], 12 scalars a row, the ring
    # of 4 K-tiles of 32 weight rows x 128 columns (16 rows at tile 32)
    (8, 128, 16 + 8 * (260 + 2 * 132 + 12) + 16384),
    (16, 128, 16 + 16 * (260 + 2 * 132 + 12) + 16384),
    (32, 128, 16 + 32 * (260 + 2 * 132 + 12) + 8192),
    (8, 16, 16 + 8 * (36 + 2 * 36 + 12) + 16384),
    (32, 256, 16 + 32 * (516 + 2 * 260 + 12) + 8192)])
def test_tile_smem_mirrors_the_layout(tile, d, floats):
    assert edge.tile_smem_bytes(tile, d) == 4 * floats


@pytest.mark.parametrize("d", [16, 128, 256])
def test_every_tile_fits_a_block(d):
    """Every tile fits one block's shared memory up to D 256, so the rule
    never needs its fallback at the widths the kernels take; at D 128 two
    blocks of any tile fit one SM (228 KB, 1 KB reserved a block)."""
    for t in edge.TILES:
        assert edge.tile_smem_bytes(t, d) <= edge.SMEM_MAX
        if d == 128:
            assert 2 * (edge.tile_smem_bytes(t, d) + 1024) <= 228 * 1024


@pytest.mark.parametrize("rows,split", [
    (0, 128), (1, 128), (1400, 128),     # the star train bucket: 11 slices
    (128 * 64, 128), (128 * 64 + 1, 256),
    (10_008, 256), (129_280, 2048)])     # the 10k box's nodes and edges
def test_weight_gradient_slices(rows, split):
    """Slices of 128 rows, or the next multiple of 128 that keeps at most
    64 of them."""
    assert edge.bwd_split(rows) == split
    assert -(-rows // split) <= edge.BWD_MAX_SLICES


def test_kept_activation_rows():
    """An edge keeps xhat of three LayerNorms, three rstd and its scale
    (3D+4 floats); a node xhat of two, two rstd and two pad floats (2D+4):
    both multiples of 4 at every width the kernels take."""
    for d in range(16, 257, 16):
        assert edge.act_edge_ld(d) == 3 * d + 4
        assert es.act_node_ld(d) == 2 * d + 4
        assert edge.act_edge_ld(d) % 4 == 0 and es.act_node_ld(d) % 4 == 0


def test_message_backward_scratch():
    """K2's scratch in the order of its C entry point: the transposed
    weight blocks, kept activations, ops, dh_i, dh_j, dpd, slice partials,
    then dh, dpos, dW."""
    n, e, d = 7, 1100, 16
    shapes = [tuple(t.shape) for t in edge.bwd_scratch(n, e, d, "cpu")]
    slices = -(-e // edge.bwd_split(e))
    assert shapes == [(4, d, d), (e, 3 * d + 4), (e, 15 * d + 4), (e, d), (e, d),
                      (e, 3),
                      (slices, 4 * d + 12, d), (n, d), (n, 3), (4 * d + 12, d)]


def test_stack_backward_buffers():
    """K6's backward buffers in the order of its C entry point, the kept
    activations per layer after the per-edge messages, the barrier's two
    zeroed counters last."""
    n, e, d, layers = 9, 600, 16, 3
    bufs = es.bwd_buffers(n, e, d, layers, "cpu")
    se, sn = -(-e // edge.bwd_split(e)), 1
    assert [tuple(t.shape) for t in bufs] == [
        (layers - 1, n, d), (layers - 1, n, 3), (layers, n, d), (e, d), (e, 3),
        (layers, e, 3 * d + 4), (layers, n, 2 * d + 4), (layers, 7, d, d),
        (n, 9 * d), (n, d),
        (n, d), (n, 3), (e, 15 * d + 4), (e, d), (e, d), (e, 3),
        (se, 4 * d + 12, d), (sn, 3 * d + 6, d), (n, d), (n, 3),
        (layers, 7 * d + 18, d), (2,)]
    assert bufs[-1].dtype == torch.int32 and not bufs[-1].any()


def test_unaligned_weights_raise_before_the_card():
    """The kernels copy the packed rows in 16-byte pieces: a view that
    starts one float into its storage is refused."""
    n, e, d = 4, 6, 16
    base = torch.zeros(edge.msg_rows(d) * d + 1)
    w = base[1:].view(edge.msg_rows(d), d)
    args = (torch.zeros(e, dtype=torch.int32), torch.zeros(e, dtype=torch.int32),
            torch.ones(e, dtype=torch.bool), torch.zeros(n, d), torch.zeros(n, 3))
    edge._check_cuda_inputs(*args, base[:-1].view(edge.msg_rows(d), d))
    with pytest.raises(ValueError, match="16-byte aligned"):
        edge._check_cuda_inputs(*args, w)
