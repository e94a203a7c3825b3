"""The traffic generator: one molecular frame per mix file, from the seed.

A copy of the measured program's ``datasets.create_molecular_boxes``
generator, read from a mix's parameters: ``atoms`` positions uniform in a
cube of side ``(atoms / density)^(1/3)`` (float32, from
``numpy.random.default_rng(geometry_seed)``), species uniform over
``species`` types.  The box has open faces.  The run's seed permutes the
atoms and draws their species: every seed gives the same graph, so the
same edge and triplet counts and the same memory, in another order
(fresh positions a seed moved DimeNet++'s triplet count by 1.2% and its
peak memory with it).  The target is the mix's expected neighbour count
over 10 (the original's "edges per atom / 10", fixed by the mix rather
than counted on a graph).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Frame:
    pos: np.ndarray      # [n, 3] float32
    atoms: np.ndarray    # [n] int32
    y: float             # the frame's energy target


def expected_degree(mix: dict) -> float:
    return mix["density"] * 4.0 / 3.0 * math.pi * mix["cutoff"] ** 3


def make_frame(mix: dict, seed: int) -> Frame:
    if mix.get("frames", 1) != 1:
        raise ValueError("a mix holds one frame: the program's step trains "
                         "one batch with one optimizer")
    n = int(mix["atoms"])
    side = (n / mix["density"]) ** (1.0 / 3.0)
    geometry = np.random.default_rng(mix["geometry_seed"])
    pos = geometry.uniform(0.0, side, size=(n, 3)).astype(np.float32)
    rng = np.random.default_rng(seed)
    pos = np.ascontiguousarray(pos[rng.permutation(n)])
    atoms = rng.integers(0, mix["species"], n).astype(np.int32)
    return Frame(pos, atoms, expected_degree(mix) / 10.0)
