"""The port's GPipe pipeline (``parallel/pp.py``) on 4 gloo CPU ranks,
against the JAX package's ``pipeline_apply`` on 4 of the 8 virtual CPU
devices of ``tests/conftest.py`` and against the port's one-rank
``sequential_apply``, at the JAX tests' toy sizes
(``tests/test_parallel.py``: ``test_pipeline_matches_sequential``,
``test_pipeline_gradients_match_sequential``,
``test_pipeline_real_egnn_layer_matches_sequential``).

Two stages: the JAX tests' toy message-passing stage and the real
``EGNNLayer`` (``egnn_pipeline_stage``, its stage parameters carried from
JAX's ``stack_stage_params`` tree by ``weights.egnn_stages_from_jax``), each
at M = 8 and M = 6 microbatches of S = 4 stages.  Tolerances: the forward
within atol 2e-5 of JAX's and of ``sequential_apply``; the parameter and
input gradients within rtol = atol = 2e-4 (the JAX EGNN test's).  JAX is
imported inside the tests only; one launch of 4 ranks runs every case."""

import numpy as np
import pytest
import torch

from geometric_message_passing_tpu_torch import weights
from geometric_message_passing_tpu_torch.ops.scatter import segment_sum
from geometric_message_passing_tpu_torch.parallel import (
    egnn_pipeline_stage, launch, make_mesh, pipeline_apply, sequential_apply)

S = 4
TIMEOUT = 120
FWD_TOL = 2e-5
GRAD_TOL = 2e-4
TOY = dict(n=12, e=20, dim=8)
EGNN = dict(n=10, e=24, dim=16)
CASES = [(stage, m) for stage in ("toy", "egnn") for m in (8, 6)]


def toy_stage(params, x, senders, receivers, mask):
    """The JAX tests' stage: gather, edge MLP, masked segment sum, residual
    update."""
    h = x["h"]
    msg = torch.tanh((h[senders] - h[receivers]) @ params["w_msg"])
    agg = segment_sum(msg, receivers, h.shape[0], mask=mask)
    return {"h": h + agg @ params["w_upd"]}


def _inputs(stage: str, m: int, seed: int = 0) -> dict:
    """numpy inputs of one case: per-stage parameters (the JAX layout for
    the toy stage; flax trees are made on the JAX side for EGNN), the
    microbatches and their graphs."""
    rng = np.random.default_rng(seed)
    if stage == "toy":
        n, e, dim = TOY["n"], TOY["e"], TOY["dim"]
        params = [{"w_msg": (rng.standard_normal((dim, dim)) * 0.3
                             ).astype(np.float32),
                   "w_upd": (rng.standard_normal((dim, dim)) * 0.3
                             ).astype(np.float32)} for _ in range(S)]
        x = {"h": rng.standard_normal((m, n, dim)).astype(np.float32)}
        mask_p = 0.8
    else:
        n, e, dim = EGNN["n"], EGNN["e"], EGNN["dim"]
        params = None
        x = {"h": rng.standard_normal((m, n, dim)).astype(np.float32),
             "pos": rng.standard_normal((m, n, 3)).astype(np.float32)}
        mask_p = 0.9
    snd = rng.integers(0, n, (m, e)).astype(np.int32)
    rcv = rng.integers(0, n, (m, e)).astype(np.int32)
    mask = rng.random((m, e)) < mask_p
    return dict(params=params, x=x, aux=(snd, rcv, mask))


def _loss(stage: str, out):
    if stage == "toy":        # the JAX gradient test's
        return torch.sin(out["h"]).sum()
    return (out["h"] ** 2).sum() + (out["pos"] ** 2).sum()


def _torch_case(stage: str, case: dict, device="cpu"):
    """(stage_fn, per-stage parameter dicts as leaves, x_mb leaves, aux)."""
    if stage == "toy":
        fn, params = toy_stage, case["params"]
    else:
        _, fn = egnn_pipeline_stage(EGNN["dim"], device=device)
        params = case["params"]
    params = [{k: torch.tensor(v, device=device, requires_grad=True)
               for k, v in p.items()} for p in params]
    x = {k: torch.tensor(v, device=device, requires_grad=True)
         for k, v in case["x"].items()}
    snd, rcv, mask = (torch.as_tensor(a, device=device) for a in case["aux"])
    return fn, params, x, (snd.long(), rcv.long(), mask)


def _grads(out_loss, params, x) -> tuple:
    out_loss.backward()
    return ([{k: v.grad.numpy().copy() for k, v in p.items()} for p in params],
            {k: v.grad.numpy().copy() for k, v in x.items()})


def _pp_rank(cases: dict) -> dict:
    mesh = make_mesh((S,), ("pp",), device="cpu")
    d = mesh.coords["pp"]
    out = {}
    for key, case in cases.items():
        stage = key[0]
        fn, params, x, aux = _torch_case(stage, case)
        res = pipeline_apply(fn, params[d], x, aux, mesh=mesh, axis="pp")
        pgrads, xgrads = _grads(_loss(stage, res), [params[d]], x)
        out[key] = dict(out={k: v.detach().numpy().copy()
                             for k, v in res.items()},
                        param_grads=pgrads[0], x_grads=xgrads)
    return out


def _sequential(stage: str, case: dict) -> dict:
    fn, params, x, aux = _torch_case(stage, case)
    res = sequential_apply(fn, params, x, aux)
    pgrads, xgrads = _grads(_loss(stage, res), params, x)
    return dict(out={k: v.detach().numpy() for k, v in res.items()},
                param_grads=pgrads, x_grads=xgrads)


def _jax_case(stage: str, m: int) -> tuple:
    """The case's inputs with the EGNN stages' weights drawn by flax, and
    JAX's pipeline outputs and gradients (parameters per stage, in the
    port's names, and inputs)."""
    import jax
    import jax.numpy as jnp

    from geometric_message_passing_tpu.ops.scatter import segment_sum as jseg
    from geometric_message_passing_tpu.parallel import make_mesh as jmesh
    from geometric_message_passing_tpu.parallel.pp import (
        egnn_pipeline_stage as jstage, pipeline_apply as japply,
        stack_stage_params)

    case = _inputs(stage, m)
    aux = tuple(jnp.asarray(a) for a in case["aux"])
    x = {k: jnp.asarray(v) for k, v in case["x"].items()}
    if stage == "toy":
        def fn(params, x, senders, receivers, mask):
            h = x["h"]
            msg = jnp.tanh((h[senders] - h[receivers]) @ params["w_msg"])
            return {"h": h + jseg(msg, receivers, h.shape[0], mask=mask)
                    @ params["w_upd"]}

        stacked = stack_stage_params([{k: jnp.asarray(v) for k, v in p.items()}
                                      for p in case["params"]])

        def to_port(tree):
            return [{k: np.asarray(v)[s] for k, v in tree.items()}
                    for s in range(S)]
    else:
        layer, fn = jstage(emb_dim=EGNN["dim"])
        e = EGNN["e"]
        stacked = stack_stage_params([
            layer.init(jax.random.PRNGKey(k), x["h"][0], x["pos"][0],
                       aux[0][0], aux[1][0], jnp.ones(e, bool))["params"]
            for k in range(S)])

        def to_port(tree):
            return [{k: v.numpy() for k, v in sd.items()}
                    for sd in weights.egnn_stages_from_jax(
                        jax.tree.map(np.asarray, tree))]
    case["params"] = to_port(stacked)
    mesh = jmesh((S,), ("pp",), devices=jax.devices()[:S])

    def loss(p, xs):
        o = japply(fn, p, xs, aux, mesh=mesh, axis="pp")
        if stage == "toy":
            return jnp.sum(jnp.sin(o["h"])), o
        return jnp.sum(o["h"] ** 2) + jnp.sum(o["pos"] ** 2), o

    (_, o), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(stacked, x)
    return case, dict(out={k: np.asarray(v) for k, v in o.items()},
                      param_grads=to_port(gp),
                      x_grads={k: np.asarray(v) for k, v in gx.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases, jax_runs = {}, {}
    for key in CASES:
        cases[key], jax_runs[key] = _jax_case(*key)
    ranks = launch.spawn(_pp_rank, S, backend="gloo", device="cpu",
                         init_file=str(tmp_path_factory.mktemp("pp")
                                       / "rendezvous"),
                         args=(cases,), timeout_s=TIMEOUT)
    seq = {key: _sequential(key[0], cases[key]) for key in CASES}
    return dict(jax=jax_runs, ranks=ranks, seq=seq)


@pytest.mark.parametrize("key", CASES, ids=[f"{s}-M{m}" for s, m in CASES])
def test_pipeline_forward_matches_jax_and_sequential(runs, key):
    for r in runs["ranks"]:           # every rank returns every output
        for name, got in r[key]["out"].items():
            np.testing.assert_allclose(got, runs["jax"][key]["out"][name],
                                       atol=FWD_TOL, rtol=0, err_msg=name)
            np.testing.assert_allclose(got, runs["seq"][key]["out"][name],
                                       atol=FWD_TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("key", CASES, ids=[f"{s}-M{m}" for s, m in CASES])
def test_pipeline_gradients_match_jax_and_sequential(runs, key):
    """Rank d's stage-parameter gradients are stage d's, and every rank
    holds the whole input gradient, as JAX's and the sequential twin's."""
    for want in (runs["jax"][key], runs["seq"][key]):
        for d, r in enumerate(runs["ranks"]):
            for name, got in r[key]["param_grads"].items():
                np.testing.assert_allclose(
                    got, want["param_grads"][d][name], atol=GRAD_TOL,
                    rtol=GRAD_TOL, err_msg=f"stage {d} {name}")
            for name, got in r[key]["x_grads"].items():
                np.testing.assert_allclose(
                    got, want["x_grads"][name], atol=GRAD_TOL,
                    rtol=GRAD_TOL, err_msg=f"rank {d} input {name}")


def test_stack_stage_params_matches_jax():
    """``stack_stage_params`` lays the stages on a leading axis as the JAX
    package's does (its tree, carried over, is what the stages are cut
    from)."""
    import jax.numpy as jnp

    from geometric_message_passing_tpu.parallel.pp import (
        stack_stage_params as jstack)
    from geometric_message_passing_tpu_torch.parallel import stack_stage_params

    per = _inputs("toy", 8)["params"]
    got = stack_stage_params([{k: torch.from_numpy(v) for k, v in p.items()}
                              for p in per])
    want = jstack([{k: jnp.asarray(v) for k, v in p.items()} for p in per])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
