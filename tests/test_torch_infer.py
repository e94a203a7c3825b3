"""The port's Predictor against the JAX package's, with bridged weights;
the bucket assertions mirror tests/test_infer.py."""

import jax
import numpy as np
import pytest
import torch

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu.experiments.infer import (
    Predictor as JaxPredictor)
from geometric_message_passing_tpu.graph import GraphLoader as JaxGraphLoader
from geometric_message_passing_tpu.models.egnn_fused import (
    EGNNFusedModel as JaxEGNNFusedModel)
from geometric_message_passing_tpu_torch.experiments.infer import Predictor
from geometric_message_passing_tpu_torch.graph import GraphLoader
from geometric_message_passing_tpu_torch.models import EGNNFusedModel
from geometric_message_passing_tpu_torch.weights import egnn_fused_from_jax

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    kw = dict(num_layers=2, emb_dim=16, in_dim=1, out_dim=2, pool="first")
    graphs = jds.create_star_graphs(num=23, fold=[4, 5], dim=3, seed=0)
    jmodel = JaxEGNNFusedModel(**kw)
    variables = jmodel.init(jax.random.PRNGKey(0),
                            next(iter(JaxGraphLoader(graphs, batch_size=8))))
    tmodel = EGNNFusedModel(**kw, device="cpu")
    tmodel.load_state_dict(
        egnn_fused_from_jax(jax.tree.map(np.asarray, variables)), strict=True)
    return jmodel, variables, tmodel, graphs


def test_predictor_matches_jax_and_reuses_bucket(models):
    jmodel, variables, tmodel, graphs = models
    jpred = JaxPredictor(jmodel, variables, batch_size=8)
    pred = Predictor(tmodel, batch_size=8, device="cpu")
    y = pred.predict(graphs)
    assert y.shape == (23, 2) and y.dtype == np.float32
    assert pred.trace_count == 1
    np.testing.assert_allclose(y, jpred.predict(graphs), atol=ATOL, rtol=RTOL)
    assert pred.pad == jpred.pad

    # direct reference: same padded batches, same outputs
    ref, left = [], len(graphs)
    for batch in GraphLoader(graphs, batch_size=8, pad=pred.pad):
        n = min(8, left)
        left -= n
        with torch.no_grad():
            ref.append(tmodel(batch)[:n].numpy())
    np.testing.assert_allclose(y, np.concatenate(ref), atol=1e-6)

    # second call, same bucket: no resizing
    y2 = pred.predict(graphs[:9])
    assert pred.trace_count == 1
    np.testing.assert_allclose(y2, y[:9], atol=1e-6)

    # bigger graphs grow the bucket exactly once
    big = jds.create_star_graphs(num=9, fold=[9], dim=3, seed=1)
    yb = pred.predict(big)
    assert yb.shape == (9, 2) and pred.trace_count == 2
    np.testing.assert_allclose(yb, jpred.predict(big), atol=ATOL, rtol=RTOL)
    # and the grown bucket still serves the small graphs with no resizing
    pred.predict(graphs[:5])
    assert pred.trace_count == 2


def test_predictor_explicit_pad_and_call(models):
    _, _, tmodel, graphs = models
    pad = (200, 512, 9)
    pred = Predictor(tmodel, batch_size=8, pad=pad, device="cpu")
    y = pred(graphs)
    assert pred.pad == pad and pred.trace_count == 1
    np.testing.assert_allclose(
        y, Predictor(tmodel, batch_size=8, device="cpu").predict(graphs),
        atol=1e-6)


def test_predict_empty(models):
    _, _, tmodel, _ = models
    out = Predictor(tmodel, batch_size=8, device="cpu").predict([])
    assert out.shape == (0, 2)


@pytest.mark.parametrize("kwargs", [dict(mesh=object()),
                                    dict(needs_triplets=True),
                                    dict(with_quads=True)])
def test_not_ported_options_raise(models, kwargs):
    """``mesh=`` is not ported yet and raises; ``needs_triplets`` and
    ``with_quads`` (not ported before the triplet models) now serve: the
    batches carry triplets (and quads), which this model ignores, so the
    result is the plain Predictor's."""
    _, _, tmodel, graphs = models
    if "mesh" in kwargs:
        with pytest.raises(NotImplementedError):
            Predictor(tmodel, batch_size=8, device="cpu", **kwargs)
        return
    pred = Predictor(tmodel, batch_size=8, device="cpu", **kwargs)
    y = pred.predict(graphs)
    assert pred.needs_triplets and pred.triplet_pad[0] > 0
    assert (pred.triplet_pad[1] > 0) == ("with_quads" in kwargs)
    np.testing.assert_allclose(
        y, Predictor(tmodel, batch_size=8, device="cpu").predict(graphs),
        atol=1e-6)


def test_default_device_raises_without_cuda(models, monkeypatch):
    _, _, tmodel, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(tmodel, batch_size=8)


def test_model_on_another_device_raises(models):
    _, _, tmodel, _ = models
    with pytest.raises(ValueError):
        Predictor(tmodel, batch_size=8, device="meta")
