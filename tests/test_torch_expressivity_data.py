"""The port's expressivity generators (``datasets.py``) and graph transforms
(``transforms.py``) against the JAX package's: graph for graph, atoms and
edge_index equal, positions to 1e-12 and labels equal, from the same seeds
(Python's ``random`` and numpy's ``default_rng`` streams)."""

import numpy as np
import pytest

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import transforms as jtf
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import transforms as ttf


def _same_graphs(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.atoms, b.atoms)
        np.testing.assert_array_equal(a.edge_index, b.edge_index)
        np.testing.assert_allclose(a.pos, b.pos, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.y.dtype == b.y.dtype


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
def test_kchains_match_jax(k):
    _same_graphs(tds.create_kchains(k), jds.create_kchains(k))
    assert [int(g.y) for g in tds.create_kchains(k)] == [0, 1]


def test_kchains_reject_short_chains():
    with pytest.raises(ValueError):
        tds.create_kchains(1)


@pytest.mark.parametrize("fold", [2, 3, 4, 5])
@pytest.mark.parametrize("seed", [0, 7])
def test_rotsym_envs_match_jax(fold, seed):
    _same_graphs(tds.create_rotsym_envs(fold=fold, seed=seed),
                 jds.create_rotsym_envs(fold=fold, seed=seed))


@pytest.mark.parametrize("name", [
    "create_two_body_envs", "create_three_body_envs",
    "create_four_body_nonchiral_envs", "create_four_body_chiral_envs",
    "create_true_chiral_envs"])
def test_environment_pairs_match_jax(name):
    _same_graphs(getattr(tds, name)(), getattr(jds, name)())


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("target", ["max", "mean"])
def test_invariant_dataset_matches_jax(dim, target):
    kw = dict(num=6, fold=4, dim=dim, target=target, seed=3)
    _same_graphs(tds.generate_invariant_dataset(**kw),
                 jds.generate_invariant_dataset(**kw))


def test_rand_rotation_matches_jax():
    a, b = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(5):
        R = tds.rand_rotation(a)
        np.testing.assert_allclose(R, jds.rand_rotation(b), atol=1e-15, rtol=0)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-12)
        assert np.linalg.det(R) == pytest.approx(1.0)


def test_transforms_match_jax():
    tg = tds.create_star_graphs(num=1, fold=[5], seed=2)[0]
    jg = jds.create_star_graphs(num=1, fold=[5], seed=2)[0]
    _same_graphs([ttf.complete_graph(tg)], [jtf.complete_graph(jg)])
    _same_graphs([ttf.set_target(tg, 0)], [jtf.set_target(jg, 0)])
    perm = np.random.default_rng(0).permutation(tg.num_nodes)
    _same_graphs([ttf.permute_graph(tg, perm)], [jtf.permute_graph(jg, perm)])
    R = ttf.random_orthogonal_matrix(3, seed=4)
    np.testing.assert_array_equal(R, jtf.random_orthogonal_matrix(3, seed=4))
    t = np.array([1.0, -2.0, 0.5])
    _same_graphs([ttf.rotate_graph(tg, R, t), ttf.rotate_graph(tg, R)],
                 [jtf.rotate_graph(jg, R, t), jtf.rotate_graph(jg, R)])
