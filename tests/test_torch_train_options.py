"""The port's training options against the JAX package's: ``loss_mask``
(the two-centre stars, half the targets scored), global-norm gradient
clipping (``GRAD_CLIP`` in the JAX package, ``grad_clip=`` in the port) and
the linear LR warmup (``LR_WARMUP`` / ``lr_warmup=``).  Each 3-epoch
``fit_regression`` of a 2-layer, 16-wide EGNN starts from the JAX model's
weights (``weights.egnn_from_jax``) and is fed the JAX engine's epoch
permutations through the ``epoch_order`` seam.

Tolerances (``tests/test_torch_train.py``'s): after 3 epochs the
per-epoch MAEs and the parameters within 1e-4; one clipped step's
gradients within 1e-6 of their largest entry and its parameters 1e-6.
Under the loss mask one leaf is exempt, by rule: a leaf whose gradients at
the first step are of rounding size on both sides (every entry below
``ROUNDING_GRAD``) and differ is held to one Adam step (the rate, 5e-4),
since Adam's first update, lr g / (|g| + 1e-8), turns two such gradients
(3.7e-9 on the port, 0 on the JAX package) into updates 0.27 lr apart.
The rule picks exactly one leaf, the second layer's last LayerNorm bias
in ``mlp_upd``, and the test asserts so."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu import graph as jgraph
from geometric_message_passing_tpu.experiments import train as jtrain
from geometric_message_passing_tpu.models.egnn import EGNNModel as JaxEGNN
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch import graph as tgraph
from geometric_message_passing_tpu_torch.experiments import train as ttrain
from geometric_message_passing_tpu_torch.models import EGNNModel
from geometric_message_passing_tpu_torch.weights import egnn_from_jax

LR = 5e-4
N_PAIRS = 2
EPOCHS = 3
BATCH = 8
ROUNDING_GRAD = 1e-7


def _data(kind, num=40, seed=0):
    gen = {"paired_star": "create_paired_star_graphs",
           "paired_star2": "create_paired_star_graphs_with_two_centers"}[kind]
    out_dim = N_PAIRS * (2 if kind == "paired_star2" else 1)
    kw = dict(num=num, fold=(4, 5), n_pairs=N_PAIRS, seed=seed)
    return getattr(jds, gen)(**kw), getattr(tds, gen)(**kw), out_dim


def _loaders(graphs, pkg, pad, batch):
    tr, va, te = pkg.random_split(graphs, [0.5, 0.2, 0.3], seed=0)
    return (pkg.GraphLoader(tr, batch, shuffle=True, seed=0, pad=pad),
            pkg.GraphLoader(va, batch, pad=pad),
            pkg.GraphLoader(te, batch, pad=pad))


def _bridged(jbatch, out_dim):
    kw = dict(num_layers=2, emb_dim=16, in_dim=N_PAIRS + 2, out_dim=out_dim,
              pool="first")
    jmodel = JaxEGNN(**kw)
    variables = jax.tree.map(np.asarray,
                             jmodel.init(jax.random.PRNGKey(0), jbatch))
    tmodel = EGNNModel(**kw, device="cpu")
    tmodel.load_state_dict(egnn_from_jax(variables), strict=True)
    return jmodel, variables, tmodel


def _assert_state(got, want_variables, atol, exempt=()):
    """Every leaf within ``atol`` (or 1e-6 of its largest entry); the
    leaves named in ``exempt`` within one Adam step."""
    want = egnn_from_jax(jax.tree.map(np.asarray, want_variables))
    for name, w in want.items():
        w = w.numpy()
        tol = LR if name in exempt else atol
        np.testing.assert_allclose(
            got[name].numpy(), w, atol=max(tol, 1e-6 * np.abs(w).max()),
            rtol=0, err_msg=name)


def _jax_epoch_orders(seed, m, n_epochs):
    """The permutations the JAX resident engine draws (train.py:415-420)."""
    _, shuffle_key = jax.random.split(jax.random.PRNGKey(seed))
    return [np.array(jax.random.permutation(
        jax.random.fold_in(shuffle_key, e), m)) for e in range(n_epochs)]


def _rounding_leaves(jmodel, variables, tmodel, loaders, mask_cols):
    """The leaves whose gradients at the first step (the first batch of
    epoch 0's permutation) are of rounding size on both sides (every entry
    below ``ROUNDING_GRAD``) and yet differ: Adam's first update makes
    each of them a step of up to lr, apart by that much."""
    jgraphs, tgraphs = loaders[0][0].graphs, loaders[1][0].graphs
    rows = _jax_epoch_orders(0, len(jgraphs), 1)[0][:BATCH]
    batch = jgraph.assemble_batch(jgraph.build_slot_data(jgraphs),
                                  jnp.asarray(rows, jnp.int32))

    def loss_of(params):
        return jtrain.l1_sum_loss(
            jmodel.apply({**variables, "params": params}, batch), batch,
            mask_cols)

    jgrads = egnn_from_jax({"params": jax.tree.map(
        np.asarray, jax.grad(loss_of)(variables["params"]))})
    work = copy.deepcopy(tmodel)
    ttrain.train_step(work, ttrain.make_tx(work.parameters(), LR),
                      tgraph.build_slot_data(tgraphs), torch.from_numpy(rows),
                      mask_cols=mask_cols)
    tgrads = {n: torch.zeros_like(p) if p.grad is None else p.grad
              for n, p in work.named_parameters()}
    return {n for n, g in jgrads.items()
            if max(g.abs().max(), tgrads[n].abs().max()) < ROUNDING_GRAD
            and not torch.equal(g, tgrads[n])}


def _track(kind, jax_kw, port_kw, monkeypatch, jax_globals=None,
           exempt_rounding=None):
    """Both 3-epoch runs, held to each other; with ``exempt_rounding`` (the
    loss's ``mask_cols``), the rule's rounding-size leaves are exempt and
    returned beside the port's result."""
    jdata, tdata, out_dim = _data(kind)
    pad = jgraph.pad_sizes(jdata, BATCH)
    jl = _loaders(jdata, jgraph, pad, BATCH)
    tl = _loaders(tdata, tgraph, pad, BATCH)
    jmodel, variables, tmodel = _bridged(next(iter(jl[0])), out_dim)
    exempt = (set() if exempt_rounding is None else _rounding_leaves(
        jmodel, variables, tmodel, (jl, tl), exempt_rounding))
    for name, value in (jax_globals or {}).items():
        monkeypatch.setattr(jtrain, name, value)
    jres = jtrain.fit_regression(jmodel, variables, *jl, n_epochs=EPOCHS,
                                 lr=LR, seed=0, **jax_kw)
    orders = _jax_epoch_orders(0, len(jl[0].graphs), EPOCHS)
    tres = ttrain.fit_regression(
        tmodel, None, *tl, n_epochs=EPOCHS, lr=LR, seed=0, device="cpu",
        epoch_order=lambda e: torch.from_numpy(orders[e]), **port_kw)
    np.testing.assert_allclose(tres.perf_per_epoch, jres.perf_per_epoch,
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose([tres.best_val, tres.test],
                               [jres.best_val, jres.test], atol=1e-4, rtol=0)
    _assert_state(tres.variables, jres.variables, atol=1e-4, exempt=exempt)
    return tres, exempt


def test_loss_mask_tracks_jax_for_3_epochs(monkeypatch):
    masked, exempt = _track("paired_star2", dict(loss_mask=True),
                            dict(loss_mask=True), monkeypatch,
                            exempt_rounding=N_PAIRS)
    assert exempt == {"convs.1.mlp_upd.norm.1.bias"}
    jdata, tdata, _ = _data("paired_star2")
    tl = _loaders(tdata, tgraph, jgraph.pad_sizes(jdata, BATCH), BATCH)
    assert next(iter(tl[1])).y.shape[-1] == 2 * N_PAIRS
    _, _, tmodel = _bridged(next(iter(_loaders(jdata, jgraph, jgraph.pad_sizes(
        jdata, BATCH), BATCH)[0])), 2 * N_PAIRS)
    full = ttrain.fit_regression(tmodel, None, *tl, n_epochs=1, lr=LR,
                                 seed=0, device="cpu")
    # scoring every column counts the second centre's angles too
    assert full.perf_per_epoch[0, 1] > masked.perf_per_epoch[0, 1]


@pytest.mark.parametrize("clip", [0.05])
def test_grad_clip_tracks_jax_for_3_epochs(monkeypatch, clip):
    _track("paired_star", {}, dict(grad_clip=clip), monkeypatch,
           jax_globals=dict(GRAD_CLIP=clip))


def test_lr_warmup_tracks_jax_for_3_epochs(monkeypatch):
    _track("paired_star", {}, dict(lr_warmup=2), monkeypatch,
           jax_globals=dict(LR_WARMUP=2))
    assert ttrain.warmup_scale(0, 2) == np.float32(0.5)
    assert ttrain.warmup_scale(5, 2) == np.float32(1)
    assert ttrain.warmup_scale(5, None) == np.float32(1)


def test_clipped_step_matches_optax():
    """One step: ``optax.clip_by_global_norm`` then Adam, against
    ``train_step(grad_clip=)``; the clip really clips (norm > clip)."""
    clip = 0.05
    jdata, tdata, out_dim = _data("paired_star", num=12)
    jslot, tslot = jgraph.build_slot_data(jdata), tgraph.build_slot_data(tdata)
    row = [4, 11, 0, 12, 12]               # two sentinel slots
    jbatch = jgraph.assemble_batch(jslot, jnp.asarray(row, jnp.int32))
    jmodel, variables, tmodel = _bridged(jbatch, out_dim)

    def loss_of(params):
        return jtrain.l1_sum_loss(jmodel.apply({"params": params}, jbatch),
                                  jbatch)

    params = variables["params"]
    jgrads = jax.grad(loss_of)(params)
    assert float(optax.global_norm(jgrads)) > clip
    tx = optax.chain(optax.clip_by_global_norm(clip), optax.adam(LR))
    updates, _ = tx.update(jgrads, tx.init(params), params)
    jnew = optax.apply_updates(params, updates)
    clipped, _ = optax.clip_by_global_norm(clip).update(jgrads, None)

    opt = ttrain.make_tx(tmodel.parameters(), LR)
    ttrain.train_step(tmodel, opt, tslot, torch.tensor(row), grad_clip=clip)
    # the last layer's position MLP takes no part: no gradient (JAX: zeros)
    _assert_state({n: torch.zeros_like(p) if p.grad is None else p.grad
                   for n, p in tmodel.named_parameters()},
                  {"params": clipped}, atol=0)
    _assert_state(tmodel.state_dict(), {"params": jnew}, atol=1e-6)
