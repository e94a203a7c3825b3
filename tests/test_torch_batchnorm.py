"""The port's BatchNorm and MLP(norm='batch') against flax's nn.BatchNorm
(the JAX package's nn.basic.BatchNorm and MLP): three train steps, each a
forward in train mode, the gradients of a fixed cotangent and an SGD step on
the scale and bias, with the running mean and variance carried, then an
eval-mode forward.  The batch holds pad rows (identical rows, as a padded
GraphBatch's pad nodes give), which count in the statistics on both sides.
Tolerance: BatchNorm alone atol = rtol = 1e-5 (float32 sums in another
order); the MLP 1e-5 of max(the tensor's largest entry, 1), since its Dense
products round differently in XLA and torch and the normalisation scales
that rounding by 1/std.  The MLP's inputs are centred: with an offset the
first Dense's weight gradient is a sum of terms that cancel (the
normalisation removes the mean), and the two packages' float32 roundings
of that cancellation differ by some 1e-5 of the largest entry; the
offset's statistics are the BatchNorm test's case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from geometric_message_passing_tpu.nn.basic import MLP as JMLP
from geometric_message_passing_tpu.nn.basic import BatchNorm as JBatchNorm
from geometric_message_passing_tpu_torch import weights
from geometric_message_passing_tpu_torch.nn.basic import MLP, BatchNorm

TOL = 1e-5
ROWS, PAD, D, STEPS, LR = 40, 9, 6, 3, 0.1


def _inputs(step: int, d: int = D, offset: bool = True) -> np.ndarray:
    """Real rows, with a per-feature offset (the fast variance's case)
    unless ``offset`` is False, and ``PAD`` identical pad rows at the
    end."""
    rng = np.random.default_rng(step)
    x = rng.normal(size=(ROWS, d)) * 0.7
    if offset:
        x = x + np.linspace(-2.0, 3.0, d)
    x[-PAD:] = x[-PAD - 1]
    return x.astype(np.float32)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=TOL,
                               rtol=TOL, err_msg=what)


def _close_scaled(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1.0), (what, err)


class _Flax(fnn.Module):
    momentum: float

    @fnn.compact
    def __call__(self, x, train: bool):
        if self.momentum == 0.9:       # the JAX package's own module
            return JBatchNorm()(x, use_running_average=not train)
        return fnn.BatchNorm(use_running_average=not train,
                             momentum=self.momentum, epsilon=1e-5)(x)


def _leaf(tree):
    """The flax BatchNorm's own entries (``scale``/``bias`` or
    ``mean``/``var``), below however many ``BatchNorm_0`` wrappers."""
    while "BatchNorm_0" in tree:
        tree = tree["BatchNorm_0"]
    return tree


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_matches_flax_over_three_steps(momentum):
    model = _Flax(momentum)
    variables = model.init(jax.random.PRNGKey(0), _inputs(0), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    rng = np.random.default_rng(7)
    # a non-trivial scale and bias, the same on both sides
    params = jax.tree.map(lambda v: v + jnp.asarray(
        rng.normal(size=v.shape) * 0.3, jnp.float32), params)

    bn = BatchNorm(D, momentum=momentum, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.asarray(_leaf(params)["scale"])))
        bn.bias.copy_(torch.from_numpy(np.asarray(_leaf(params)["bias"])))

    def loss(prm, st, x, ct):
        out, mut = model.apply({"params": prm, "batch_stats": st}, x,
                               train=True, mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 2), has_aux=True))
    for step in range(STEPS):
        x = _inputs(step)
        ct = np.random.default_rng(100 + step).normal(
            size=x.shape).astype(np.float32)
        (g_p, g_x), (out, stats) = grad_fn(params, stats, x, ct)
        params = jax.tree.map(lambda v, g: v - LR * g, params, g_p)

        xt = torch.from_numpy(x).requires_grad_()
        bn.train()
        got = bn(xt)
        (got * torch.from_numpy(ct)).sum().backward()
        gp, st = _leaf(g_p), _leaf(stats)
        _close(got.detach(), out, f"output, step {step}")
        _close(xt.grad, g_x, f"input gradient, step {step}")
        _close(bn.weight.grad, gp["scale"], f"scale gradient, step {step}")
        _close(bn.bias.grad, gp["bias"], f"bias gradient, step {step}")
        _close(bn.running_mean, st["mean"], f"running mean, step {step}")
        _close(bn.running_var, st["var"], f"running variance, step {step}")
        with torch.no_grad():
            for t in (bn.weight, bn.bias):
                t -= LR * t.grad
                t.grad = None

    x = _inputs(STEPS)
    want = model.apply({"params": params, "batch_stats": stats}, x,
                       train=False)
    bn.eval()
    with torch.no_grad():
        _close(bn(torch.from_numpy(x)), want, "eval-mode output")


def test_batchnorm_statistics_are_flax_fast_variance():
    """Biased E[x^2] - E[x]^2, clipped at 0, normalises and enters the
    running average as ra = m * ra + (1 - m) * batch; a constant feature
    (variance 0, clipped) normalises to its bias."""
    x = _inputs(0)
    x[:, 0] = 5.0
    bn = BatchNorm(D, momentum=0.9)
    bn.train()
    out = bn(torch.from_numpy(x)).detach().numpy()
    mean = x.mean(0)
    var = np.maximum((x * x).mean(0) - mean * mean, 0.0)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(out[:, 1:], ((x - mean) / np.sqrt(var + 1e-5))
                               [:, 1:], rtol=1e-4, atol=1e-4)
    bn.eval()
    with torch.no_grad():
        again = bn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(again, (x - bn.running_mean.numpy())
                               / np.sqrt(bn.running_var.numpy() + 1e-5),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("norm_final", [True, False])
def test_mlp_batch_norm_matches_jax_over_three_steps(norm_final):
    hidden = (16, 8)
    jm = JMLP(hidden=hidden, norm="batch", norm_final=norm_final,
              act_final=norm_final)
    variables = jm.init(jax.random.PRNGKey(1), _inputs(0, offset=False), train=False)
    params, stats = variables["params"], variables["batch_stats"]
    tm = MLP(D, hidden, norm="batch", norm_final=norm_final,
             act_final=norm_final, generator=torch.Generator().manual_seed(0))

    def load(prm, st):
        sd = {}
        weights._mlp(sd, "m", jax.tree.map(np.asarray, prm),
                     jax.tree.map(np.asarray, st))
        tm.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)

    load(params, stats)

    def loss(prm, st, x, ct):
        out, mut = jm.apply({"params": prm, "batch_stats": st}, x, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * ct), (out, mut["batch_stats"])

    grad_fn = jax.jit(jax.grad(loss, argnums=(0, 2), has_aux=True))
    for step in range(STEPS):
        x = _inputs(step, offset=False)
        ct = np.random.default_rng(200 + step).normal(
            size=(ROWS, hidden[-1])).astype(np.float32)
        (g_p, g_x), (out, stats) = grad_fn(params, stats, x, ct)
        xt = torch.from_numpy(x).requires_grad_()
        tm.train()
        got = tm(xt)
        (got * torch.from_numpy(ct)).sum().backward()
        _close_scaled(got.detach(), out, f"output, step {step}")
        _close_scaled(xt.grad, g_x, f"input gradient, step {step}")
        want_g = {}
        weights._mlp(want_g, "m", jax.tree.map(np.asarray, g_p),
                     jax.tree.map(np.asarray, stats))
        for name, prm in tm.named_parameters():
            _close_scaled(prm.grad, want_g[f"m.{name}"], f"{name} gradient, "
                   f"step {step}")
        for name, buf in tm.named_buffers():
            _close_scaled(buf, want_g[f"m.{name}"], f"{name}, step {step}")
        params = jax.tree.map(lambda v, g: v - LR * g, params, g_p)
        with torch.no_grad():
            for prm in tm.parameters():
                prm -= LR * prm.grad
                prm.grad = None

    x = _inputs(STEPS, offset=False)
    want = jm.apply({"params": params, "batch_stats": stats}, x, train=False)
    tm.eval()
    with torch.no_grad():
        _close_scaled(tm(torch.from_numpy(x)), want, "eval-mode output")


def test_mlp_weights_need_batch_stats():
    jm = JMLP(hidden=(4,), norm="batch")
    variables = jm.init(jax.random.PRNGKey(0), _inputs(0), train=False)
    with pytest.raises(ValueError, match="batch_stats"):
        weights._mlp({}, "m", jax.tree.map(np.asarray, variables["params"]))
