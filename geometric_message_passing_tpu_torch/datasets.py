"""Synthetic geometric-graph generators — host-side, numpy (port of
``datasets.py``): the star graphs and their paired variants (the stars
with labelled spoke pairs, with two centres, and the complete graphs with
labelled pairs), the expressivity benchmarks (k-chains,
the rotationally symmetric stars, the incompleteness environment pairs, the
invariant-rotations probe) and the molecular boxes.

Every draw comes from the same generator as in the JAX package (Python's
``random`` for the star graphs and the rotsym stars, numpy's
``default_rng`` for the rotations and the boxes), in the same order, so the
same seed gives bit-identical graphs.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import List

import numpy as np

from .graph import Graph, to_undirected
from .ops.radius_graph import radius_graph

__all__ = [
    "create_star_graphs",
    "create_paired_star_graphs",
    "create_paired_star_graphs_with_two_centers",
    "create_paired_complete_graphs",
    "create_kchains",
    "create_rotsym_envs",
    "create_two_body_envs",
    "create_three_body_envs",
    "create_four_body_nonchiral_envs",
    "create_four_body_chiral_envs",
    "create_true_chiral_envs",
    "generate_invariant_dataset",
    "create_molecular_boxes",
    "rand_rotation",
]


def _rot_z(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _rot_y(angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def rand_rotation(rng: np.random.Generator) -> np.ndarray:
    """Haar-random rotation matrix (QR of a Gaussian, det fixed to +1)."""
    M = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(M)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def _random_spokes(rnd: random.Random, n_spoke: int, dim: int) -> List[np.ndarray]:
    """First spoke at (1,0,0); remaining spokes random on circle/sphere."""
    pos = [np.array([0.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])]
    if dim == 2:
        for _ in range(1, n_spoke):
            a = rnd.uniform(0, 2 * math.pi)
            pos.append(np.array([math.cos(a), math.sin(a), 0.0]))
    else:
        for _ in range(1, n_spoke):
            theta = rnd.uniform(0, 2 * math.pi)
            phi = rnd.uniform(0, math.pi)
            pos.append(
                np.array(
                    [
                        math.sin(phi) * math.cos(theta),
                        math.sin(phi) * math.sin(theta),
                        math.cos(phi),
                    ]
                )
            )
    return pos


def _shear_and_normalize(rnd: random.Random, pos: List[np.ndarray],
                         keep_tail: int = 0) -> List[np.ndarray]:
    """Random shear toward the average vector, then unit-normalize spokes.
    ``keep_tail`` positions at the end are left as they are (the second
    centre of the two-centre stars)."""
    avg = sum(pos)
    alpha = rnd.uniform(-1, 2)
    if keep_tail:
        body = [p + alpha * avg for p in pos[1:-keep_tail]]
        return pos[:1] + [v / np.linalg.norm(v) for v in body] + pos[-keep_tail:]
    body = [p + alpha * avg for p in pos[1:]]
    return pos[:1] + [v / np.linalg.norm(v) for v in body]


def _angle(v1: np.ndarray, v2: np.ndarray) -> float:
    return math.acos(
        float(np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2)))
    )


def _star_edges(n_spoke: int) -> np.ndarray:
    return np.array([[0] * n_spoke, list(range(1, n_spoke + 1))], dtype=np.int32)


def create_star_graphs(num=5, fold=(3,), dim=3, target="max", seed=0) -> List[Graph]:
    """Star graphs; target = max or mean pairwise spoke angle."""
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if target not in ("max", "mean"):
        raise ValueError(f"target must be 'max' or 'mean', got {target!r}")
    rnd = random.Random(seed)
    dataset = []
    for _ in range(num):
        n_spoke = rnd.choice(list(fold))
        atoms = np.zeros(1 + n_spoke, dtype=np.int32)
        edge_index = _star_edges(n_spoke)
        pos = _shear_and_normalize(rnd, _random_spokes(rnd, n_spoke, dim))
        angles = [_angle(v1, v2) for v1, v2 in itertools.combinations(pos[1:], 2)]
        y = np.array([max(angles) if target == "max" else sum(angles) / len(angles)],
                     dtype=np.float32)
        dataset.append(Graph(atoms, to_undirected(edge_index), np.stack(pos), y))
    return dataset


def _pair_atoms(n_pairs: int, n_rest: int) -> List[int]:
    """Atom types: the centre 0, pair i's two spokes i + 1, the rest
    n_pairs + 1."""
    labels = [0]
    for i in range(n_pairs):
        labels += [i + 1] * 2
    labels += [n_pairs + 1] * n_rest
    return labels


def _check_paired(dim: int, n_pairs: int, smallest: int, need: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if n_pairs * 2 + need > smallest:
        raise ValueError(f"{n_pairs} pairs need graphs of at least "
                         f"{n_pairs * 2 + need} spokes or nodes, got {smallest}")


def _pair_angles(spokes: List[np.ndarray], n_pairs: int,
                 origin: np.ndarray = None) -> List[float]:
    """The angle within each pair of spokes, seen from ``origin`` (the
    centre at 0 when None)."""
    if origin is not None:
        spokes = [s - origin for s in spokes]
    return [_angle(spokes[2 * j], spokes[2 * j + 1]) for j in range(n_pairs)]


def create_paired_star_graphs(num=5, fold=(5,), dim=3, n_pairs=2,
                              seed=0) -> List[Graph]:
    """Stars whose first ``2 n_pairs`` spokes form labelled pairs; targets:
    the angle at the centre within each pair."""
    _check_paired(dim, n_pairs, min(fold), 0)
    rnd = random.Random(seed)
    dataset = []
    for _ in range(num):
        n_spoke = rnd.choice(list(fold))
        atoms = np.array(_pair_atoms(n_pairs, n_spoke - 2 * n_pairs),
                         dtype=np.int32)
        edge_index = _star_edges(n_spoke)
        pos = _shear_and_normalize(rnd, _random_spokes(rnd, n_spoke, dim))
        y = np.array(_pair_angles(pos[1:2 * n_pairs + 1], n_pairs),
                     dtype=np.float32)
        dataset.append(Graph(atoms, to_undirected(edge_index), np.stack(pos), y))
    return dataset


def create_paired_star_graphs_with_two_centers(num=5, fold=(5,), dim=3,
                                               n_pairs=2,
                                               seed=0) -> List[Graph]:
    """Paired stars with a second centre (the last node, unsheared) joined
    to every spoke; targets: each pair's angle at the first centre, then at
    the second (``2 n_pairs`` columns)."""
    _check_paired(dim, n_pairs, min(fold), 0)
    rnd = random.Random(seed)
    dataset = []
    for _ in range(num):
        n_spoke = rnd.choice(list(fold))
        atoms = np.array(_pair_atoms(n_pairs, n_spoke - 2 * n_pairs) + [0],
                         dtype=np.int32)
        edge_index = np.array([[0] * n_spoke + [n_spoke + 1] * n_spoke,
                               list(range(1, n_spoke + 1)) * 2], dtype=np.int32)
        # n_spoke + 1 random points; the last becomes the second centre
        pos = _shear_and_normalize(
            rnd, _random_spokes(rnd, n_spoke + 1, dim), keep_tail=1)
        spokes = pos[1:2 * n_pairs + 1]
        y = np.array(_pair_angles(spokes, n_pairs)
                     + _pair_angles(spokes, n_pairs, origin=pos[-1]),
                     dtype=np.float32)
        dataset.append(Graph(atoms, to_undirected(edge_index), np.stack(pos), y))
    return dataset


def create_paired_complete_graphs(num=5, n_nodes=(6,), dim=3, n_pairs=2,
                                  seed=0) -> List[Graph]:
    """Complete graphs of ``n_nodes`` nodes: the origin and random unit
    points (no fixed first spoke), the first ``2 n_pairs`` of them in
    labelled pairs; targets: each pair's angle at the origin."""
    _check_paired(dim, n_pairs, min(n_nodes), 1)
    rnd = random.Random(seed)
    dataset = []
    for _ in range(num):
        n_node = rnd.choice(list(n_nodes))
        atoms = np.array(_pair_atoms(n_pairs, n_node - 2 * n_pairs - 1),
                         dtype=np.int32)
        edge_index = np.array(
            [[i for i in range(n_node) for j in range(i + 1, n_node)],
             [j for i in range(n_node) for j in range(i + 1, n_node)]],
            dtype=np.int32)
        # _random_spokes' draws without its fixed first spoke
        pos = _random_spokes(rnd, n_node, dim)
        pos = pos[:1] + pos[2:]
        pos = _shear_and_normalize(rnd, pos)
        y = np.array(_pair_angles(pos[1:2 * n_pairs + 1], n_pairs),
                     dtype=np.float32)
        dataset.append(Graph(atoms, to_undirected(edge_index), np.stack(pos), y))
    return dataset


# ---------------------------------------------------------------------------
# Expressivity benchmark environments (labels are int32 class ids)
# ---------------------------------------------------------------------------


def create_kchains(k: int) -> List[Graph]:
    """Two k-chains that differ only at one end (label 0 and 1): the
    long-range propagation test."""
    if k < 2:
        raise ValueError(f"k must be at least 2, got {k}")
    dataset = []
    for label, head_x in ((0, -4.0), (1, 4.0)):
        n = k + 2
        atoms = np.zeros(n, dtype=np.int32)
        edge_index = np.array(
            [list(range(n - 1)), list(range(1, n))], dtype=np.int32)
        pos = np.array(
            [[head_x, -3.0, 0.0]]
            + [[0.0, 5.0 * i, 0.0] for i in range(k)]
            + [[4.0, 5.0 * (k - 1) + 3.0, 0.0]],
            dtype=np.float64,
        )
        pos = pos - pos.mean(axis=0)
        dataset.append(
            Graph(atoms, to_undirected(edge_index), pos, np.array(label, np.int32)))
    return dataset


def create_rotsym_envs(fold: int = 3, seed: int = 0) -> List[Graph]:
    """An n-fold rotationally symmetric star (label 0) and the same star
    turned about z by q < 2 pi / fold (label 1)."""
    rnd = random.Random(seed)
    atoms = np.zeros(1 + fold, dtype=np.int32)
    edge_index = to_undirected(_star_edges(fold))
    x = np.array([1.0, 0.0, 0.0])
    pos = [np.zeros(3), x]
    for count in range(1, fold):
        R = _rot_z(2 * math.pi / fold * count)
        pos.append(x @ R.T)
    pos = np.stack(pos)
    data1 = Graph(atoms, edge_index, pos, np.array(0, np.int32))
    q = 2 * math.pi / (fold + rnd.randint(1, fold))
    pos2 = pos @ _rot_z(q).T
    data2 = Graph(atoms, edge_index, pos2, np.array(1, np.int32))
    return [data1, data2]


def _env_pair(pos0, pos1) -> List[Graph]:
    """Two environments (labels 0, 1): node 0 joined to every other node."""
    n = len(pos0)
    atoms = np.zeros(n, dtype=np.int32)
    edge_index = to_undirected(
        np.array([[0] * (n - 1), list(range(1, n))], dtype=np.int32))
    return [
        Graph(atoms, edge_index, np.asarray(pos0, np.float64), np.array(0, np.int32)),
        Graph(atoms, edge_index, np.asarray(pos1, np.float64), np.array(1, np.int32)),
    ]


def create_two_body_envs() -> List[Graph]:
    """A pair that no set of distances from the centre tells apart."""
    return _env_pair(
        [[0, 0, 0], [5, 0, 0], [3, 0, 4]],
        [[0, 0, 0], [5, 0, 0], [-5, 0, 0]],
    )


def create_three_body_envs() -> List[Graph]:
    """A pair that no set of distances and angles tells apart."""
    a = (5, 0, 5)
    b = (5, 5, 5)
    c = (0, 5, 5)
    return _env_pair(
        [[0, 0, 0], list(a), [b[0], b[1], b[2]], [-b[0], -b[1], b[2]], [c[0], c[1], c[2]]],
        [[0, 0, 0], list(a), [b[0], b[1], b[2]], [-b[0], -b[1], b[2]], [c[0], -c[1], c[2]]],
    )


def create_four_body_nonchiral_envs() -> List[Graph]:
    """A pair that three-body terms do not tell apart and four-body terms do."""
    a1, a2, a3 = (3, 2, -4), (0, 2, 5), (-3, 2, -4)
    b1, b2, b3 = (3, -2, -4), (0, -2, 5), (-3, -2, -4)
    c = (0, 5, 0)
    Q = _rot_y(2 * math.pi / 10)
    rb = [np.asarray(b, float) @ Q for b in (b1, b2, b3)]
    base = [[0, 0, 0], list(a1), list(a2), list(a3)] + [list(v) for v in rb]
    return _env_pair(base + [[c[0], c[1], c[2]]], base + [[c[0], -c[1], c[2]]])


def create_four_body_chiral_envs() -> List[Graph]:
    """Mirror images in y.  The base configuration is symmetric under
    x -> -x, so the pair is one rotation (R_z(pi)) apart: no
    rotation-invariant model separates it (``create_true_chiral_envs`` is
    a genuinely chiral pair)."""
    a1, a2, a3 = (3, 0, -4), (0, 0, 5), (-3, 0, -4)
    c = (0, 5, 0)
    base = [[0, 0, 0], list(a1), list(a2), list(a3)]
    return _env_pair(base + [[c[0], c[1], c[2]]], base + [[c[0], -c[1], c[2]]])


def create_true_chiral_envs() -> List[Graph]:
    """A chiral mirror pair (no internal mirror symmetry): separable
    exactly by parity-sensitive (pseudoscalar) features."""
    base = [
        [0.0, 0.0, 0.0],
        [2.0, 0.0, 0.0],
        [0.0, 3.0, 0.5],
        [-0.5, 0.0, 4.0],
        [1.0, 1.5, 2.0],
    ]
    mirror = [[x, -y, z] for (x, y, z) in base]
    return _env_pair(base, mirror)


def generate_invariant_dataset(num=5, fold=3, dim=2, target="max",
                               seed=0) -> List[Graph]:
    """One star and ``num - 1`` randomly rotated copies sharing its label:
    the data-level invariance probe.  The spokes are sheared but not
    re-normalised."""
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if target not in ("max", "mean"):
        raise ValueError(f"target must be 'max' or 'mean', got {target!r}")
    rnd = random.Random(seed)
    nprng = np.random.default_rng(seed)
    atoms = np.zeros(1 + fold, dtype=np.int32)
    edge_index = to_undirected(_star_edges(fold))
    pos = _random_spokes(rnd, fold, dim)
    avg = sum(pos)
    alpha = rnd.uniform(-1, 2)
    pos = pos[:1] + [p + alpha * avg for p in pos[1:]]
    angles = [_angle(v1, v2) for v1, v2 in itertools.combinations(pos[1:], 2)]
    y = np.array([max(angles) if target == "max" else sum(angles) / len(angles)],
                 dtype=np.float32)
    pos = np.stack(pos)
    dataset = [Graph(atoms, edge_index, pos, y)]
    for _ in range(num - 1):
        R = rand_rotation(nprng)
        dataset.append(Graph(atoms, edge_index, pos @ R.T, y))
    return dataset


def create_molecular_boxes(num=1, n_nodes=10_000, cutoff=3.0,
                           avg_degree=14.0, n_species=8, seed=0,
                           max_num_neighbors=None) -> List[Graph]:
    """Synthetic molecular boxes, the box-scale benchmark's data: ``n_nodes``
    atoms uniform in a cube sized so that the expected radius-graph degree
    at ``cutoff`` is ``avg_degree``, ``n_species`` atom types, edges from
    ``ops.radius_graph``.  Target: edges per atom / 10."""
    density = avg_degree / (4.0 / 3.0 * np.pi * cutoff**3)
    side = (n_nodes / density) ** (1.0 / 3.0)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        pos = rng.uniform(0.0, side, size=(n_nodes, 3)).astype(np.float32)
        atoms = rng.integers(0, n_species, n_nodes).astype(np.int32)
        edge_index = radius_graph(pos, cutoff,
                                  max_num_neighbors=max_num_neighbors)
        y = np.asarray([edge_index.shape[1] / max(n_nodes, 1) / 10.0],
                       np.float32)
        out.append(Graph(atoms, edge_index, pos, y))
    return out
