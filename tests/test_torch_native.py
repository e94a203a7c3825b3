"""The port's host C++ graph code (``csrc/host/``, built by
``ops/_host_build.py``) against the JAX package's, bitwise, on the
inputs of ``tests/test_native.py``: the epoch batcher against JAX's Python
``batch_graphs`` (and its native batcher where that builds), the
triplet / quad enumerator against JAX's Python loop and the port's numpy
twin, the radius graph against JAX's numpy twin and the port's.  And the
build itself: six processes building into one directory at once leave one
library and no temporary file."""

import multiprocessing as mp

import numpy as np
import pytest

from geometric_message_passing_tpu import datasets as jds
from geometric_message_passing_tpu.graph import batch_graphs, pad_sizes
from geometric_message_passing_tpu.native import have_native
from geometric_message_passing_tpu.native.batch import (
    FlatDataset as JaxFlatDataset, fast_build_batches as jax_fast_batches)
from geometric_message_passing_tpu.ops.radius_graph import radius_graph_python
from geometric_message_passing_tpu.triplets import _build_triplets_py
from geometric_message_passing_tpu_torch import datasets as tds
from geometric_message_passing_tpu_torch.native import (
    FlatDataset, fast_build_batches, fast_build_triplets)
from geometric_message_passing_tpu_torch.ops import _host_build
from geometric_message_passing_tpu_torch.ops.radius_graph import (
    radius_graph, radius_graph_plain)
from geometric_message_passing_tpu_torch.triplets import (
    build_triplets, build_triplets_plain)

FIELDS = ("atoms", "pos", "senders", "receivers", "graph_id", "y",
          "node_mask", "edge_mask", "graph_mask", "first_node")


def test_batcher_matches_jax_batch_graphs():
    jgraphs = jds.create_paired_star_graphs(num=13, fold=[5, 6], n_pairs=2,
                                            seed=1)
    tgraphs = tds.create_paired_star_graphs(num=13, fold=[5, 6], n_pairs=2,
                                            seed=1)
    batch_size = 4
    pad = pad_sizes(jgraphs, batch_size)
    order = np.random.default_rng(0).permutation(len(jgraphs))
    out = fast_build_batches(FlatDataset(tgraphs), order, batch_size, *pad)
    native = (jax_fast_batches(JaxFlatDataset(jgraphs), order, batch_size,
                               *pad) if have_native() else None)
    for b in range((len(order) + batch_size - 1) // batch_size):
        chunk = [jgraphs[i] for i in order[b * batch_size:(b + 1) * batch_size]]
        ref = batch_graphs(chunk, *pad)
        for name in FIELDS:
            got, want = out[name][b], np.asarray(getattr(ref, name))
            if name.endswith("_mask"):
                got = got.astype(bool)
            np.testing.assert_array_equal(got, want, err_msg=name)
            if native is not None:
                np.testing.assert_array_equal(out[name][b], native[name][b])


def test_batcher_refuses_a_batch_beyond_its_bucket():
    graphs = tds.create_star_graphs(num=6, fold=[5], seed=0)
    n_pad, e_pad, g_pad = pad_sizes(graphs, 2)
    with pytest.raises(ValueError, match="does not fit"):
        fast_build_batches(FlatDataset(graphs), np.arange(6), 3, n_pad, e_pad,
                           g_pad)
    with pytest.raises(ValueError, match="outside"):
        fast_build_batches(FlatDataset(graphs), np.array([0, 6]), 2, n_pad,
                           e_pad, g_pad)


def test_triplets_match_jax_and_numpy():
    rng = np.random.default_rng(0)
    for _ in range(5):
        n = int(rng.integers(4, 30))
        e = int(rng.integers(n, 5 * n))
        ei = rng.integers(0, n, size=(2, e)).astype(np.int32)
        for wq in (False, True):
            ref = _build_triplets_py(ei, n, wq)
            for out in (build_triplets(ei, n, wq), fast_build_triplets(ei, n, wq),
                        build_triplets_plain(ei, n, wq)):
                assert len(out) == len(ref)
                for a, b in zip(out, ref):
                    assert a.dtype == np.int32
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="outside"):
        build_triplets(np.array([[0, 5], [1, 0]]), 3)


def test_radius_graph_matches_jax_and_numpy():
    rng = np.random.default_rng(0)
    for seed, (n, d, r, use_batch, loop, k) in enumerate([
        (40, 3, 0.7, False, False, None),
        (60, 3, 0.5, True, False, None),
        (50, 2, 0.6, True, True, None),
        (80, 3, 0.9, True, False, 4),
        (1, 3, 0.5, False, True, None),
        (0, 3, 0.5, False, False, None),
        (2000, 3, 0.15, False, False, None),     # past the first buffer
    ]):
        pos = rng.random((n, d))
        batch = np.sort(rng.integers(0, 3, n)) if use_batch else None
        got = radius_graph(pos, r, batch, loop, k)
        want = radius_graph_python(pos, r, batch, loop, k)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=f"case {seed}")
        np.testing.assert_array_equal(
            got, radius_graph_plain(pos, r, batch, loop, k))
    assert got.shape[1] > 4 * 2000            # the retry with a larger cap


def _build_into(build_dir):
    from geometric_message_passing_tpu_torch.ops import _host_build as hb

    return str(hb.build(build_dir))


def test_six_processes_build_one_library(tmp_path):
    with mp.get_context("spawn").Pool(6) as pool:
        paths = pool.map(_build_into, [tmp_path] * 6, chunksize=1)
    assert set(paths) == {str(_host_build.target(tmp_path))}
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["host.lock", _host_build.target(tmp_path).name])
