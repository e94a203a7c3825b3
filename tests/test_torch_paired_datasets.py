"""The port's paired generators against the JAX package's, graph for
graph: atoms, edge_index and y equal, positions within 1e-12 (both draw
from one ``random.Random(seed)`` stream in the same order, in float64)."""

import random

import numpy as np
import pytest

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu_torch import datasets as tds

GENERATORS = {
    "create_paired_star_graphs": [dict(fold=(5,)), dict(fold=(4, 5, 7))],
    "create_paired_star_graphs_with_two_centers": [dict(fold=(4,)),
                                                   dict(fold=(5, 6, 7))],
    "create_paired_complete_graphs": [dict(n_nodes=(6,)),
                                      dict(n_nodes=(5, 8))],
}
CASES = [(name, kw) for name, kws in GENERATORS.items() for kw in kws]


@pytest.mark.parametrize("name, kw", CASES,
                         ids=[f"{n[len('create_'):]}-{i % 2}"
                              for i, (n, _) in enumerate(CASES)])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("n_pairs", [1, 2])
def test_paired_generators_match_jax(name, kw, seed, dim, n_pairs):
    want = getattr(jds, name)(num=25, dim=dim, n_pairs=n_pairs, seed=seed, **kw)
    got = getattr(tds, name)(num=25, dim=dim, n_pairs=n_pairs, seed=seed, **kw)
    assert len(got) == len(want) == 25
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.atoms, w.atoms)
        np.testing.assert_array_equal(g.edge_index, w.edge_index)
        np.testing.assert_array_equal(g.y, w.y)
        assert g.y.dtype == w.y.dtype == np.float32
        np.testing.assert_allclose(g.pos, w.pos, atol=1e-12, rtol=0)
    two = name.endswith("two_centers")
    assert got[0].y.shape == ((2 * n_pairs if two else n_pairs),)
    if dim == 2:
        assert all(np.all(g.pos[:, 2] == 0) for g in got)


@pytest.mark.parametrize("keep_tail", [0, 1, 2])
def test_shear_and_normalize_matches_jax(keep_tail):
    rng = np.random.default_rng(keep_tail)
    pos = [np.zeros(3)] + [rng.normal(size=3) for _ in range(6)]
    want = jds._shear_and_normalize(random.Random(5), list(pos), keep_tail)
    got = tds._shear_and_normalize(random.Random(5), list(pos),
                                   keep_tail=keep_tail)
    np.testing.assert_allclose(np.stack(got), np.stack(want), atol=1e-12,
                               rtol=0)
    if keep_tail:
        np.testing.assert_array_equal(np.stack(got[-keep_tail:]),
                                      np.stack(pos[-keep_tail:]))
    norms = np.linalg.norm(np.stack(got[1:len(got) - keep_tail]), axis=1)
    np.testing.assert_allclose(norms, 1.0, rtol=1e-12)


def test_pair_atoms_and_bad_arguments():
    assert tds._pair_atoms(2, 3) == jds._pair_atoms(2, 3) == [0, 1, 1, 2, 2,
                                                               3, 3, 3]
    with pytest.raises(ValueError):
        tds.create_paired_star_graphs(num=2, fold=(3,), n_pairs=2)
    with pytest.raises(ValueError):
        tds.create_paired_complete_graphs(num=2, n_nodes=(4,), n_pairs=2)
    with pytest.raises(ValueError):
        tds.create_paired_star_graphs_with_two_centers(num=2, dim=4)
