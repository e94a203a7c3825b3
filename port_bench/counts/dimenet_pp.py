"""Operations and segment sums of one ``dimenet_pp`` training step, from
shapes.

``flops``: the multiply-adds (2 flops each) of every ``nn.Linear`` of the
plain reference's step (``reference/dimenet_pp.py``), forward and
backward: ``[m, k] x [k, n]`` counts ``2 m k n`` forward, once more for
the weight's gradient and once more where the input needs one (the
triplet basis needs none; the radial basis does, through its trainable
frequencies).  Elementwise work and the geometry are not counted.

``k3_calls``: the triplet fold, one sum per interaction block and
``triplet_chunk`` slice of the padded triplets into the padded edges,
each after the first adding the accumulator.  ``k4_calls``: each output
block's gated-edge sum into the nodes (one per ``edge_chunk`` slice), the
pool, and the embedding table's gradient (95 rows, no mask).
"""

from __future__ import annotations

K3_IN_INTERACTIONS = True


def _slices(n: int, chunk) -> list:
    step = n if chunk is None or n <= chunk else chunk
    return [min(a + step, n) - a for a in range(0, max(n, 1), max(step, 1))]


def _lin(m, k, n, input_grad: bool = True) -> float:
    return 2.0 * m * k * n * (3 if input_grad else 2)


def flops(a: dict, shapes: dict) -> float:
    n, e, t = shapes["nodes"], shapes["edges"], shapes["triplets"]
    h, nr, ns = a["hidden_channels"], a["num_radial"], a["num_spherical"]
    i, b, o = a["int_emb_size"], a["basis_emb_size"], a["out_emb_channels"]
    f = _lin(e, nr, h) + _lin(e, 3 * h, h)                    # embedding block
    out = (_lin(e, nr, h) + _lin(n, h, o) + a["num_output_layers"] * _lin(n, o, o)
           + _lin(n, o, a["out_dim"]))
    f += (a["num_layers"] + 1) * out
    inter = (2 * _lin(e, h, h) + _lin(e, nr, b) + _lin(e, b, h) + _lin(e, h, i)
             + _lin(t, ns * nr, b, input_grad=False) + _lin(t, b, i)
             + _lin(e, i, h) + _lin(e, h, h)
             + 2 * (a["num_before_skip"] + a["num_after_skip"]) * _lin(e, h, h))
    return f + a["num_layers"] * inter


def k4_calls(a: dict, shapes: dict) -> list:
    n, e, g = shapes["nodes_pad"], shapes["edges_pad"], shapes["graphs_pad"]
    h = a["hidden_channels"]
    chunk = a.get("edge_chunk") if a.get("chunk_output_blocks", True) else None
    per_block = [(rows, h, n, True, False) for rows in _slices(e, chunk)]
    return (per_block * (a["num_layers"] + 1) + [(n, 1, g, True, False)]
            + [(n, h, 95, False, False)])


def k3_calls(a: dict, shapes: dict) -> list:
    e, t = shapes["edges_pad"], shapes["triplets_pad"]
    fold = [(rows, a["int_emb_size"], e, True, k > 0)
            for k, rows in enumerate(_slices(t, a.get("triplet_chunk")))]
    return fold * a["num_layers"]
