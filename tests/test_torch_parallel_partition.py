"""The port's Morton partitioning (``parallel/partition.py``) against the
JAX package's ``parallel/partition.py``: keys, permutations, relabeled
graphs and ``partition_stats`` bitwise on random positions and on the
JAX box tests' molecular boxes, and the partition's locality as
``tests/test_parallel.py::TestGpBoxScale`` asserts it (k 8)."""

import numpy as np
import pytest

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.parallel import (
    morton_key, morton_partition_graph, morton_permutation, partition_stats,
    permute_graph_nodes)


def _jax_graph(g):
    from geometric_message_passing_tpu.graph import Graph as JGraph

    return JGraph(atoms=g.atoms, edge_index=g.edge_index, pos=g.pos, y=g.y)


@pytest.mark.parametrize("bits", [4, 10, 21])
def test_morton_key_and_permutation_match_jax(bits):
    from geometric_message_passing_tpu.parallel import partition as jp

    rng = np.random.default_rng(bits)
    for pos in (rng.normal(size=(500, 3)).astype(np.float32),
                rng.integers(0, 3, (200, 3)).astype(np.float64),  # ties
                np.zeros((5, 3))):
        np.testing.assert_array_equal(morton_key(pos, bits),
                                      jp.morton_key(pos, bits))
        np.testing.assert_array_equal(morton_permutation(pos, bits),
                                      jp.morton_permutation(pos, bits))
    with pytest.raises(ValueError, match="bits"):
        morton_key(np.zeros((2, 3)), 22)


def test_partition_of_a_box_matches_jax_and_is_local():
    """The 4000-atom box at k 8: the relabeled graph and both partitions'
    stats equal JAX's; Morton's boundary fraction is below 0.35 and under
    half the raw order's."""
    from geometric_message_passing_tpu.parallel import partition as jp

    g = tds.create_molecular_boxes(num=1, n_nodes=4000, cutoff=2.5,
                                   avg_degree=8, n_species=4, seed=0)[0]
    n = (g.num_nodes + 7) // 8 * 8
    gm = morton_partition_graph(g)
    jgm = jp.morton_partition_graph(_jax_graph(g))
    for field in ("atoms", "edge_index", "pos", "y"):
        np.testing.assert_array_equal(getattr(gm, field),
                                      np.asarray(getattr(jgm, field)))
    raw = partition_stats(g.edge_index[0], g.edge_index[1], n, 8)
    mor = partition_stats(gm.edge_index[0], gm.edge_index[1], n, 8)
    assert raw == jp.partition_stats(g.edge_index[0], g.edge_index[1], n, 8)
    assert mor == jp.partition_stats(gm.edge_index[0], gm.edge_index[1], n, 8)
    assert mor["boundary_fraction"] < 0.35
    assert mor["boundary_fraction"] < raw["boundary_fraction"] / 2


@pytest.mark.parametrize("k", [2, 4])
def test_partition_stats_with_a_mask_match_jax(k):
    from geometric_message_passing_tpu.parallel import partition as jp

    rng = np.random.default_rng(k)
    s = rng.integers(0, 40, 300)
    r = rng.integers(0, 40, 300)
    m = rng.random(300) > 0.3
    assert partition_stats(s, r, 40, k, m) == jp.partition_stats(s, r, 40, k,
                                                                  m)


def test_permute_preserves_the_graph():
    """Relabeling is an isomorphism: the same edges as position pairs and
    the same species; the permutation's inverse restores the graph."""
    g = tds.create_molecular_boxes(num=1, n_nodes=300, cutoff=2.5,
                                   avg_degree=8, n_species=4, seed=1)[0]
    perm = morton_permutation(g.pos)
    gm = permute_graph_nodes(g, perm)

    def edge_geoms(gr):
        s, r = gr.edge_index
        return set(map(tuple, np.round(
            np.concatenate([gr.pos[s], gr.pos[r]], 1), 5).tolist()))

    assert edge_geoms(g) == edge_geoms(gm)
    assert sorted(g.atoms.tolist()) == sorted(gm.atoms.tolist())
    back = permute_graph_nodes(gm, np.argsort(perm))
    np.testing.assert_array_equal(back.edge_index, g.edge_index)
    np.testing.assert_array_equal(back.pos, g.pos)
