"""The port's rank mesh and collectives (``parallel/mesh.py``) and its
launcher (``parallel/launch.py``) on gloo CPU ranks, against the JAX
package's mesh under ``shard_map`` on the 8 virtual CPU devices of
``tests/conftest.py``.  Collectives of float32 data: sums and means to
atol 1e-6, data movement exact.  JAX is imported inside the tests only, so
a rank imports none of it."""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from geometric_message_passing_tpu_torch.parallel import launch
from geometric_message_passing_tpu_torch.parallel import mesh as tmesh
from geometric_message_passing_tpu_torch.parallel.mesh import collectives

N_DEV = 4
TIMEOUT = 120
RING = [(i, (i + 1) % N_DEV) for i in range(N_DEV)]
PARTIAL = [(0, 2), (1, 3)]          # ranks 0 and 1 receive nothing: zeros
EXACT = ("all_gather", "all_gather_tiled", "all_to_all_00", "all_to_all_01",
         "ppermute_ring", "ppermute_partial", "axis_index")


def _spawn(fn, world, tmp_path, *args, timeout_s=TIMEOUT):
    return launch.spawn(fn, world, backend="gloo", device="cpu",
                        init_file=str(tmp_path / "rendezvous"), args=args,
                        timeout_s=timeout_s)


def _inputs():
    return np.random.default_rng(0).normal(size=(N_DEV, N_DEV, 3, 6)).astype(
        np.float32)


def _collectives_rank(x: np.ndarray) -> dict:
    mesh = tmesh.make_mesh(device="cpu")
    v = torch.from_numpy(x[mesh.coords["dp"]])
    out = {
        "all_reduce_sum": collectives.all_reduce_sum(mesh, v),
        "all_reduce_mean": collectives.all_reduce_mean(mesh, v),
        "all_gather": collectives.all_gather(mesh, v),
        "all_gather_tiled": collectives.all_gather(mesh, v, tiled=True),
        "all_to_all_00": collectives.all_to_all(mesh, v, split_axis=0,
                                                concat_axis=0),
        "all_to_all_01": collectives.all_to_all(mesh, v, split_axis=0,
                                                concat_axis=1),
        "ppermute_ring": collectives.ppermute(mesh, v, RING),
        "ppermute_partial": collectives.ppermute(mesh, v, PARTIAL),
        "axis_index": torch.tensor(collectives.axis_index(mesh)),
        "psum_scatter": collectives.reduce_scatter_sum(mesh, v),
    }
    out = {k: t.numpy() for k, t in out.items()}
    out["unchanged"] = np.array_equal(v.numpy(), x[mesh.coords["dp"]])
    # this rank's rows of a global batch, gathered back whole
    full = {"x": np.arange(N_DEV * 6, dtype=np.float32).reshape(N_DEV, 6),
            "m": np.ones((N_DEV, 3), np.float32)}
    local = {k: a[tmesh.process_local_slice(N_DEV)] for k, a in full.items()}
    part = tmesh.global_batch_from_local(mesh, local)
    out["global_x"] = collectives.all_gather(mesh, part["x"],
                                             tiled=True).numpy()
    out["global_sum"] = float(collectives.all_reduce_sum(
        mesh, part["x"].sum()))
    return out


def _jax_collectives(x: np.ndarray) -> dict:
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from geometric_message_passing_tpu.parallel.mesh import (
        collectives as jc, make_mesh as jmesh)

    mesh = jmesh((N_DEV,), ("dp",), devices=jax.devices()[:N_DEV])
    names = ("all_reduce_sum", "all_reduce_mean", "all_gather",
             "all_gather_tiled", "all_to_all_00", "all_to_all_01",
             "ppermute_ring", "ppermute_partial", "axis_index",
             "psum_scatter")

    def body(v):                 # this device's block, x[r]
        outs = (jc.all_reduce_sum(v), jc.all_reduce_mean(v),
                jc.all_gather(v), jc.all_gather(v, tiled=True),
                jc.all_to_all(v, split_axis=0, concat_axis=0),
                jc.all_to_all(v, split_axis=0, concat_axis=1),
                jc.ppermute(v, RING), jc.ppermute(v, PARTIAL),
                jnp.asarray(jc.axis_index()),
                jax.lax.psum_scatter(v, "dp", scatter_dimension=0,
                                     tiled=True))
        return tuple(o[None] for o in outs)

    got = jax.jit(shard_map(body, mesh=mesh, in_specs=P("dp"),
                            out_specs=P("dp"), check_vma=False))(
        jnp.asarray(x.reshape(N_DEV * N_DEV, 3, 6)))
    return {k: np.asarray(v) for k, v in zip(names, got)}


@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    x = _inputs()
    ranks = _spawn(_collectives_rank, N_DEV,
                   tmp_path_factory.mktemp("collectives"), x)
    return x, ranks, _jax_collectives(x)


@pytest.mark.parametrize("name", ["all_reduce_sum", "all_reduce_mean",
                                  "psum_scatter", *EXACT])
def test_collective_matches_jax(collective_runs, name):
    _, ranks, want = collective_runs
    for r, out in enumerate(ranks):
        got, ref = out[name], want[name][r]
        assert got.shape == ref.shape, (name, got.shape, ref.shape)
        if name in EXACT:
            np.testing.assert_array_equal(got, ref, err_msg=f"{name} {r}")
        else:
            np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0,
                                       err_msg=f"{name} {r}")
        assert out["unchanged"]


def test_global_batch_from_local(collective_runs):
    _, ranks, _ = collective_runs
    full = np.arange(N_DEV * 6, dtype=np.float32).reshape(N_DEV, 6)
    for out in ranks:
        np.testing.assert_array_equal(out["global_x"], full)
        assert out["global_sum"] == full.sum()


def _hybrid_rank() -> dict:
    mesh = tmesh.make_hybrid_mesh((1, 4), (2, 1), ("dp", "gp"), device="cpu")
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    local = torch.tensor(x[mesh.coords["dp"], mesh.coords["gp"]])
    s_gp = collectives.all_reduce_sum(mesh, local, "gp")
    s_all = collectives.all_reduce_sum(mesh, s_gp, "dp")
    return {"ranks": mesh.ranks.tolist(), "coords": mesh.coords,
            "shape": mesh.shape, "s_gp": float(s_gp), "s_all": float(s_all)}


def test_hybrid_mesh_layout_and_sums(tmp_path):
    """``make_hybrid_mesh((1, 4), (2, 1), ("dp", "gp"))`` is JAX's device
    grid on ranks, and a gp sum then a dp sum give JAX's values."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from geometric_message_passing_tpu.parallel.mesh import (
        collectives as jc, make_hybrid_mesh as jhybrid)

    jm = jhybrid(ici_shape=(1, 4), dcn_shape=(2, 1), axis_names=("dp", "gp"))
    ids = np.asarray([[d.id for d in row] for row in jm.devices])

    def body(x):
        s_gp = jc.all_reduce_sum(x[0, 0], "gp")
        return s_gp[None, None], jc.all_reduce_sum(s_gp, "dp")[None, None]

    s_gp, s_all = jax.jit(shard_map(
        body, mesh=jm, in_specs=P("dp", "gp"),
        out_specs=(P("dp", "gp"), P("dp", "gp")), check_vma=False))(
        jnp.arange(8, dtype=jnp.float32).reshape(2, 4))
    ranks = _spawn(_hybrid_rank, 8, tmp_path)
    np.testing.assert_array_equal(tmesh.hybrid_rank_grid((1, 4), (2, 1)), ids)
    for rank, out in enumerate(ranks):
        assert out["ranks"] == ids.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
        assert out["shape"] == {"dp": 2, "gp": 4}
        dp, gp = out["coords"]["dp"], out["coords"]["gp"]
        assert ids[dp, gp] == rank
        np.testing.assert_allclose(out["s_gp"], np.asarray(s_gp)[dp, gp])
        np.testing.assert_allclose(out["s_all"], np.asarray(s_all)[dp, gp])
    assert {out["s_gp"] for out in ranks} == {6.0, 22.0}


@pytest.mark.parametrize("ici,dcn", [((1,), (2,)), ((2, 2), (2, 1)),
                                     ((1, 2), (3, 1)), ((2,), (1,))])
def test_hybrid_rank_grid_matches_jax(ici, dcn):
    """The grid for other shapes against the JAX package's single-process
    emulation of the same layout (device ids)."""
    import jax

    from geometric_message_passing_tpu.parallel.mesh import (
        make_hybrid_mesh as jhybrid)

    names = ("dp", "gp")[:len(ici)]
    jm = jhybrid(ici_shape=ici, dcn_shape=dcn, axis_names=names)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert len(jax.devices()) >= ids.size
    np.testing.assert_array_equal(tmesh.hybrid_rank_grid(ici, dcn), ids)


def test_process_local_slice_matches_jax():
    from geometric_message_passing_tpu.parallel.mesh import (
        process_local_slice as jslice)

    for n in range(0, 14):
        for count in range(1, 6):
            for p in range(count):
                try:
                    want = jslice(n, p, count)
                except ValueError:
                    with pytest.raises(ValueError, match="divisible"):
                        tmesh.process_local_slice(n, p, count)
                    continue
                assert tmesh.process_local_slice(n, p, count) == want
    assert tmesh.process_local_slice(8) == slice(0, 8)   # no group: world 1


def test_multihost_mesh_outside_a_launcher(monkeypatch):
    """One process, no launcher environment: a world-1 mesh (an in-process
    store, no rendezvous), every axis of size 1; the default slice is the
    whole batch."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_multihost_mesh(("dp",), device="cpu")
        assert mesh.axis_names == ("dp",) and mesh.shape == {"dp": 1}
        assert mesh.backend == "gloo" and mesh.device == torch.device("cpu")
        mesh2 = tmesh.make_multihost_mesh(("dp", "gp"), device="cpu")
        assert mesh2.shape == {"dp": 1, "gp": 1}
        assert tmesh.process_local_slice(8) == slice(0, 8)
        x = torch.arange(6.0)
        assert torch.equal(collectives.all_reduce_sum(mesh2, x, "gp"), x)
        assert torch.equal(collectives.all_reduce_sum(mesh, x, "dp"), x)
        assert collectives.all_gather(mesh2, x, "gp").shape == (1, 6)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_make_mesh_needs_a_group_and_the_world():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh((1,), device="cpu")


def test_nccl_needs_one_gpu_per_rank(monkeypatch, tmp_path):
    """NCCL with more ranks than GPUs raises before any process or group
    starts; NCCL on CPU ranks raises; CUDA ranks without CUDA raise."""
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        launch.spawn(_failing_rank, 2, backend="gloo")
    with pytest.raises(ValueError, match="NCCL needs CUDA"):
        launch.spawn(_failing_rank, 2, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one GPU per rank"):
        launch.spawn(_failing_rank, 2, backend="nccl")
    for name in ("LOCAL_WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="one GPU per rank"):
        tmesh.init_distributed("nccl", f"file://{tmp_path / 'rdzv'}", rank=0,
                               world_size=2, device="cuda:0")
    assert not dist.is_initialized()


def _failing_rank() -> int:
    if dist.get_rank() == 1:
        raise ValueError("planted failure on rank 1")
    return dist.get_rank()


def _hanging_rank() -> int:
    if dist.get_rank() == 0:
        time.sleep(300)
    return dist.get_rank()


def _dying_rank() -> int:
    if dist.get_rank() == 1:
        os._exit(3)
    return dist.get_rank()


def test_launch_returns_results_in_rank_order(tmp_path):
    """Each rank in a world of 3 on one CPU thread, results in rank order."""
    assert _spawn(_rank_and_world, 3, tmp_path) == [(r, 3, 1) for r in range(3)]


def _rank_and_world():
    return dist.get_rank(), dist.get_world_size(), torch.get_num_threads()


@pytest.mark.parametrize("fn,match,timeout_s", [
    (_failing_rank, "(?s)rank 1 failed:.*planted failure", 60),
    (_dying_rank, "rank 1 died", 60),
    (_hanging_rank, "did not finish within", 8)])
def test_a_failed_rank_fails_the_launch(tmp_path, fn, match, timeout_s):
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match=match) as info:
        _spawn(fn, 2, tmp_path, timeout_s=timeout_s)
    assert time.perf_counter() - t < timeout_s + 30
    if fn is _failing_rank:
        assert "ValueError" in str(info.value)
