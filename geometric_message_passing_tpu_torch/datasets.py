"""Synthetic geometric-graph generators — host-side, numpy (port of
``datasets.py``; only the star graphs so far).

All geometric randomness comes from Python's ``random`` module, drawn in the
same order as the JAX package, so the same seed gives bit-identical graphs.
"""

from __future__ import annotations

import itertools
import math
import random
from typing import List

import numpy as np

from .graph import Graph, to_undirected

__all__ = ["create_star_graphs"]


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


def _shear_and_normalize(rnd: random.Random,
                         pos: List[np.ndarray]) -> List[np.ndarray]:
    """Random shear toward the average vector, then unit-normalize spokes."""
    avg = sum(pos)
    alpha = rnd.uniform(-1, 2)
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
