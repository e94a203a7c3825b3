"""Operations and segment sums of one ``mace_ff`` training step, from shapes.

``flops``: the multiply-adds (2 flops each) of every contraction of the
plain reference's step (``reference/mace_ff.py``), forward and backward,
without checkpoint recompute: each product ``[m, k] x [k, n]`` counts
``2 m k n`` forward, and as much again in the backward for each operand
that needs a gradient (data, one-hot species, constants need none).
Elementwise work and the edge geometry are not counted.

``k4_calls`` / ``k3_calls``: every segment sum the measured program issues
in a step at the batch's (padded) shapes, as ``(rows, width, segments,
mask, acc)``: each conv chunk's message sum (``edge_chunk`` rows, the
tail padded) and each layer's pool.  The program's rule that applies the
post-conv linear inside the chunks above 2**28 accumulator elements sets
the width there.
"""

from __future__ import annotations

from port_bench.reference import _e3
from port_bench.reference._e3 import Irrep

K3_IN_INTERACTIONS = False
FOLD_ACC_ELEMS = 2 ** 28


def _irreps(args):
    emb, lmax = args["emb_dim"], args["max_ell"]
    hidden = [(emb, Irrep(l, (-1) ** l)) for l in range(lmax + 1)]
    return hidden, [(emb, Irrep(0, 1))], _e3.sh_irreps(lmax)


def _mm(m, k, n, grads: int) -> float:
    """A product's flops forward and in the backward (``grads`` operands
    that need a gradient)."""
    return 2.0 * m * k * n * (1 + grads)


def _linear(n, irreps_in, irreps_out) -> float:
    square = ([ir for _, ir in irreps_in] == [ir for _, ir in irreps_out]
              and len({m for m, _ in irreps_in}) == 1
              and len({m for m, _ in irreps_out}) == 1)
    f = 0.0
    for ko, (mo, ro) in enumerate(irreps_out):
        kis = [ko] if square else [ki for ki, (_, ri) in enumerate(irreps_in)
                                   if ri == ro]
        for ki in kis:
            f += _mm(n * ro.dim, irreps_in[ki][0], mo, 2)
    return f


def flops(args: dict, shapes: dict) -> float:
    n, e = shapes["nodes"], shapes["edges"]
    hidden, scalars, sh = _irreps(args)
    species, c, d = args["in_dim"], args["emb_dim"], _e3.irreps_dim(
        [(1, ir) for _, ir in hidden])
    f = _mm(n, species, c, 1)                                # node embedding
    for layer in range(args["num_layers"]):
        irreps_in = scalars if layer == 0 else hidden
        for p in _e3.tp_paths(irreps_in, [(species, Irrep(0, 1))], hidden):
            f += _mm(n, species, p.mul_in1 * p.mul_out, 1)   # z W
            f += _mm(n * p.mul_in1, p.ir_in1.dim, p.ir_out.dim, 1)  # x C
            f += _mm(n * p.mul_out, p.mul_in1, p.ir_out.dim, 2)     # bmm
        f += _linear(n, irreps_in, irreps_in)                # linear_up
        tp_out, paths = _e3.tp_paths_uvu(irreps_in, sh, hidden)
        width = sum(p.mul_in1 for p in paths)
        f += _mm(e, args["num_bessel"], 64, 1)               # radial MLP
        f += 2 * _mm(e, 64, 64, 2) + _mm(e, 64, width, 2)
        for p in paths:
            f += _mm(e, p.ir_in2.dim, p.ir_in1.dim * p.ir_out.dim, 0)  # Y C
            f += _mm(e * p.mul_in1, p.ir_in1.dim, p.ir_out.dim, 1)    # x K
        f += _linear(n, tp_out, hidden)                      # post-conv linear
        coupling = [(1, ir) for _, ir in hidden]
        for _, ir in hidden:                                 # contraction
            o = ir.dim
            for nu in range(1, args["correlation"] + 1):
                k = _e3.coupling_paths(coupling, nu).get(ir, 0)
                f += _mm(o * d ** nu, k, c, 1)               # U W
                f += _mm(n * c, d, o * d ** (nu - 1), 2)     # x . A
        f += _linear(n, hidden, hidden)                      # product linear
        f += _linear(n, hidden, [(1, Irrep(0, 1))])          # readout
    return f


def k4_calls(args: dict, shapes: dict) -> list:
    n, e, g = shapes["nodes_pad"], shapes["edges_pad"], shapes["graphs_pad"]
    hidden, scalars, sh = _irreps(args)
    chunk = args.get("edge_chunk")
    rows = e if chunk is None or e <= chunk else chunk
    n_chunks = -(-e // rows)
    calls = []
    for layer in range(args["num_layers"]):
        tp_out, _ = _e3.tp_paths_uvu(scalars if layer == 0 else hidden, sh,
                                     hidden)
        width = _e3.irreps_dim(tp_out)
        if n_chunks > 1 and n * width > FOLD_ACC_ELEMS:
            width = _e3.irreps_dim(hidden)
        calls += [(rows, width, n, True, False)] * n_chunks
        calls.append((n, 1, g, True, False))                 # the pool
    return calls


def k3_calls(args: dict, shapes: dict) -> list:
    return []
