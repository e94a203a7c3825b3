"""The port's edge-partitioned ``MACEForceField`` (``gp_axis``, ``mesh``,
``forward(..., halo_plan=...)``, the ``RealAgnostic*`` blocks'
``halo_exchange``) on 4 gloo CPU ranks against the JAX package's
single-device ``MACEForceField`` with the same weights
(``weights.mace_ff_from_jax``): the twins of
``tests/test_parallel.py::TestGpMaceForceField`` (4 star graphs, emb 4,
max_ell 2, correlation 2; forward, gradients of sum(E^2), ``edge_chunk``
16, ``halo_stats``) and of ``TestGpBoxScale::
test_gp_mace_box_matches_single_device`` (the Morton-partitioned 800-atom
box, here at k 4, forward only as there), plus the interaction without
a residual.

Tolerances are the JAX tests': energies atol 5e-4 / rtol 1e-4, gradients
atol = rtol = 2e-3 per parameter (each rank's gradients summed over the
axis).  JAX is imported inside the tests only, so a rank imports none of
it; one launch of 4 ranks runs every case."""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu_torch.models import MACEForceField
from geometric_message_passing_tpu_torch.nn import mace_blocks as mb
from geometric_message_passing_tpu_torch.parallel import (
    build_halo_plan, gp_rank_batch, halo_stats, launch, make_mesh,
    morton_partition_graph)
from geometric_message_passing_tpu_torch.parallel.data import (
    all_reduce_grads)

K = 4
TIMEOUT = 120
FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")
STAR_KW = dict(num_layers=2, emb_dim=4, max_ell=2, correlation=2, in_dim=2,
               node_chunk=None)
BOX_KW = dict(num_layers=2, emb_dim=4, max_ell=2, correlation=2, in_dim=4,
              node_chunk=None, avg_num_neighbors=8.0)
# case -> (batch, model options, gradients too)
CASES = {"star": ("star", {}, True),
         "star_chunked": ("star", dict(edge_chunk=16), False),
         "star_no_residual": ("star", dict(
             interaction="RealAgnosticInteractionBlock",
             interaction_first="RealAgnosticInteractionBlock"), True),
         "box": ("box", {}, False)}


def _batch(kind):
    if kind == "star":   # the JAX test's: pad_sizes' node multiple of 8
        graphs = tds.create_star_graphs(num=4, fold=[4, 5], dim=3, seed=0)
        return batch_graphs(graphs, *pad_sizes(graphs, 4))
    g = tds.create_molecular_boxes(num=1, n_nodes=800, cutoff=2.5,
                                   avg_degree=8, n_species=4, seed=0)[0]
    g = morton_partition_graph(g)
    n_pad, e_pad, g_pad = pad_sizes([g], 1)
    return batch_graphs([g], -(-n_pad // K) * K, e_pad, g_pad)


def _kw(case):
    kind, extra, _ = CASES[case]
    return {**(STAR_KW if kind == "star" else BOX_KW), **extra}


def _plan(batch):
    return build_halo_plan(batch.senders.numpy(), batch.receivers.numpy(),
                           batch.num_nodes, K,
                           edge_mask=batch.edge_mask.numpy())


def _gp_rank(sds: dict) -> dict:
    """Every case on one of 4 ranks: the energies, and the gradients of
    sum(E^2) summed over the axis."""
    mesh = make_mesh((K,), ("gp",), device="cpu")
    me = mesh.coords["gp"]
    out = {}
    for case, (kind, _, grads) in CASES.items():
        big = _batch(kind)
        plan = _plan(big)
        model = MACEForceField(**_kw(case), gp_axis="gp", mesh=mesh,
                               device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in sds[case].items()})
        energy = model(gp_rank_batch(big, plan, me), halo_plan=plan.local(me))
        res = {"energy": energy.detach().numpy().copy()}
        if grads:
            (energy ** 2).sum().backward()
            params = list(model.parameters())
            all_reduce_grads(mesh, params, "gp")
            res["grads"] = {n: p.grad.numpy().copy()
                            for n, p in model.named_parameters()}
        out[case] = res
    return out


def _jax_case(case):
    """JAX's single-device energies and gradients of sum(E^2), and its
    weights, in the port's names."""
    import jax
    import jax.numpy as jnp

    from geometric_message_passing_tpu import graph as jgraph
    from geometric_message_passing_tpu.models.mace_ff import (
        MACEForceField as JMACEFF)
    from geometric_message_passing_tpu_torch.weights import mace_ff_from_jax

    big = _batch(CASES[case][0])
    jb = jgraph.GraphBatch(triplets=None, **{
        f: jnp.asarray(getattr(big, f).numpy()) for f in FIELDS})
    model = JMACEFF(**_kw(case))
    variables = model.init(jax.random.PRNGKey(0), jb)

    def loss(params):
        return jnp.sum(jnp.square(model.apply({**variables, "params": params},
                                              jb)))

    twin = MACEForceField(**_kw(case), device="cpu")
    as_np = jax.tree.map(np.asarray, variables)
    out = {"energy": np.asarray(model.apply(variables, jb)),
           "sd": {k: v.numpy() for k, v in mace_ff_from_jax(as_np,
                                                            twin).items()}}
    if CASES[case][2]:
        grads = mace_ff_from_jax({**as_np, "params": jax.tree.map(
            np.asarray, jax.grad(loss)(variables["params"]))}, twin)
        out["grads"] = {k: v.numpy() for k, v in grads.items()}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_runs = {case: _jax_case(case) for case in CASES}
    ranks = launch.spawn(_gp_rank, K, backend="gloo", device="cpu",
                         init_file=str(tmp_path_factory.mktemp("gp")
                                       / "rendezvous"),
                         args=({c: r["sd"] for c, r in jax_runs.items()},),
                         timeout_s=TIMEOUT)
    return jax_runs, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_gp_forward_matches_jax_single_device(runs, case):
    """Every rank returns the whole [G, 1], within JAX's gp tolerance of
    JAX's single-device forward (edge chunks of 16 compose with the halo;
    both interactions exchange their features)."""
    jax_runs, ranks = runs
    for r in ranks:
        np.testing.assert_allclose(r[case]["energy"],
                                   jax_runs[case]["energy"], atol=5e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][2]])
def test_gp_gradients_match_jax_single_device(runs, case):
    """The gradients of sum(E^2), each rank's summed over the axis (the
    energy's sum is psum_replicated, so not k times too large), against
    JAX's single-device gradients, on every rank."""
    jax_runs, ranks = runs
    want = jax_runs[case]["grads"]
    for r in ranks:
        assert r[case]["grads"].keys() == want.keys()
        for name, g in want.items():
            np.testing.assert_allclose(r[case]["grads"][name], g, atol=2e-3,
                                       rtol=2e-3, err_msg=name)


def test_halo_stats_accounting():
    """The star batch's plan at k 4 (JAX's assertions) and the box's: the
    packed exchange beats the all-gather at the box's locality."""
    big = _batch("star")
    st = halo_stats(_plan(big), 4 * (1 + 3 + 5), num_nodes=big.num_nodes)
    assert st["k"] == K and st["wire_bytes"] > 0
    assert st["useful_bytes"] <= st["wire_bytes"]
    assert st["wire_bytes"] <= 2 * st["allgather_bytes"]
    box = _batch("box")
    st = halo_stats(_plan(box), 4 * (1 + 3 + 5), num_nodes=box.num_nodes)
    assert st["wire_bytes"] < st["allgather_bytes"]


def test_gp_options_need_a_mesh_and_the_sum_pool():
    """``gp_axis`` without a mesh, a mesh without the axis, a non-sum pool
    and ``halo_plan`` on a model without ``gp_axis`` raise ``ValueError``;
    a gp model without a plan runs the single-rank forward."""
    with pytest.raises(ValueError, match="needs mesh="):
        MACEForceField(**STAR_KW, gp_axis="gp", device="cpu")

    class Fake:
        shape = {"dp": 2}

    with pytest.raises(ValueError, match="needs mesh="):
        MACEForceField(**STAR_KW, gp_axis="gp", mesh=Fake(), device="cpu")
    Fake.shape = {"gp": 2}
    for pool in ("mean", "first"):
        with pytest.raises(ValueError, match="pool"):
            MACEForceField(**STAR_KW, gp_axis="gp", mesh=Fake(), pool=pool,
                           device="cpu")
    big = _batch("star")
    plain = MACEForceField(**STAR_KW, device="cpu")
    with pytest.raises(ValueError, match="gp_axis"):
        plain(big, halo_plan={})
    gp = MACEForceField(**STAR_KW, gp_axis="gp", mesh=Fake(), device="cpu")
    gp.load_state_dict(plain.state_dict())
    torch.testing.assert_close(gp(big), plain(big), atol=0, rtol=0)


@pytest.mark.parametrize("name", ["RealAgnosticResidualInteractionBlock",
                                  "RealAgnosticInteractionBlock"])
def test_halo_exchange_feeds_the_catalog_to_the_convolution(name):
    """One process: a ``halo_exchange`` that appends a shuffled copy of
    the rows after ``linear_up`` (a catalog), with the senders moved onto
    the copies, gives the plain call's outputs and gradients exactly; an
    exchange that drops the copies' values changes the messages."""
    from geometric_message_passing_tpu_torch.irreps import Irreps

    gen = torch.Generator().manual_seed(0)
    sh, hidden = Irreps.spherical_harmonics(2), Irreps("4x0e+4x1o+4x2e")
    block = mb.interaction_classes[name](
        Irreps("2x0e"), hidden, sh, Irreps("8x0e"), hidden, hidden,
        avg_num_neighbors=3.0, generator=gen)
    rng = np.random.default_rng(0)
    n, e = 12, 40
    attrs = torch.nn.functional.one_hot(torch.from_numpy(
        rng.integers(0, 2, n)), 2).float()
    feats = torch.from_numpy(rng.normal(size=(n, hidden.dim)).astype(
        np.float32))
    ea = torch.from_numpy(rng.normal(size=(e, sh.dim)).astype(np.float32))
    ef = torch.from_numpy(rng.normal(size=(e, 8)).astype(np.float32))
    snd = torch.from_numpy(rng.integers(0, n, e))
    rcv = torch.from_numpy(rng.integers(0, n, e))
    perm = torch.from_numpy(rng.permutation(n))
    where = torch.argsort(perm)        # row i of the copy is row perm[i]

    def run(exchange, senders):
        x = feats.clone().requires_grad_()
        m, sc = block(attrs, x, ea, ef, senders, rcv, halo_exchange=exchange)
        total = m.sum() + (0 if sc is None else sc.sum())
        total.backward()
        return m.detach(), x.grad

    want = run(None, snd)
    got = run(lambda x: torch.cat([x, x[perm]]), where[snd] + n)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    dropped = run(lambda x: torch.cat([x, torch.zeros_like(x)]), snd + n)
    assert not torch.allclose(dropped[0], want[0])
