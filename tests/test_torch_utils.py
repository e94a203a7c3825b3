"""The port's utilities against the JAX package's: plot_2d / plot_3d draw
the same lines and scatter data (Agg backend); cost_report and roofline
count the same FLOPs, bytes and transcendentals as XLA's CPU cost analysis
for a matmul (2*M*N*K FLOPs; inputs plus output bytes) and a matmul under
tanh; time_fn and profile_trace run; utils exports the JAX names."""

import json
import os

import matplotlib

matplotlib.use("Agg", force=True)

import jax.numpy as jnp  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from geometric_message_passing_tpu import datasets as jds  # noqa: E402
from geometric_message_passing_tpu import utils as jutils  # noqa: E402
from geometric_message_passing_tpu.utils import plot as jplot  # noqa: E402
from geometric_message_passing_tpu.utils import profiler as jprof  # noqa: E402
from geometric_message_passing_tpu.utils import roofline as jroof  # noqa: E402
from geometric_message_passing_tpu_torch import datasets as tds  # noqa: E402
from geometric_message_passing_tpu_torch import utils as tutils  # noqa: E402
from geometric_message_passing_tpu_torch.utils import plot as tplot  # noqa: E402
from geometric_message_passing_tpu_torch.utils import profiler as tprof  # noqa: E402
from geometric_message_passing_tpu_torch.utils import roofline as troof  # noqa: E402


def _star(pkg):
    return pkg.create_star_graphs(num=2, fold=[5], dim=3, target="max")[0]


def _lines(ax):
    return [np.asarray(line.get_data_3d() if hasattr(line, "get_data_3d")
                       else line.get_data()) for line in ax.lines]


@pytest.mark.parametrize("kind", ["plot_2d", "plot_3d"])
def test_plots_draw_what_jax_draws(kind):
    want = getattr(jplot, kind)(_star(jds), lim=1.2)
    got = getattr(tplot, kind)(_star(tds), lim=1.2)
    assert got.name == want.name
    assert len(got.lines) == len(want.lines) == _star(tds).edge_index.shape[1]
    for a, b in zip(_lines(got), _lines(want)):
        np.testing.assert_array_equal(a, b)
    assert len(got.collections) == len(want.collections) == 1
    sa, sb = got.collections[0], want.collections[0]
    if kind == "plot_2d":
        np.testing.assert_array_equal(sa.get_offsets(), sb.get_offsets())
        assert [t.get_text() for t in got.texts] == [
            t.get_text() for t in want.texts]
    else:
        np.testing.assert_array_equal(np.asarray(sa._offsets3d),
                                      np.asarray(sb._offsets3d))
    np.testing.assert_array_equal(sa.get_array(), sb.get_array())
    assert got.get_xlim() == want.get_xlim()
    got.figure.canvas.draw()
    for ax in (got, want):
        plt.close(ax.figure)


def test_plot_2d_reuses_given_axis():
    _, ax_in = plt.subplots()
    assert tplot.plot_2d(_star(tds), ax=ax_in) is ax_in
    plt.close(ax_in.figure)


def _operands(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(64, 32)).astype(np.float32),
            rng.normal(size=(32, 48)).astype(np.float32))


def test_cost_report_matches_xla_on_a_matmul():
    a, b = _operands()
    want = jprof.cost_report(lambda x, y: x @ y, jnp.asarray(a), jnp.asarray(b))
    got = tprof.cost_report(lambda x, y: x @ y, torch.from_numpy(a),
                            torch.from_numpy(b))
    assert got["flops"] == want["flops"] == 2 * 64 * 32 * 48
    assert got["bytes_accessed"] == want["bytes_accessed"] == 4 * (
        64 * 32 + 32 * 48 + 64 * 48)
    assert got["roofline_bound"] == "memory"
    assert got["aten_ops"] == 1
    assert got["t_flops_s"] == got["flops"] / tprof.H100_PEAK_FLOPS
    assert got["t_bytes_s"] == got["bytes_accessed"] / tprof.H100_PEAK_BYTES


@pytest.mark.parametrize("fn", ["matmul", "tanh of a matmul"])
def test_roofline_matches_xla(fn):
    a, b = _operands(1)
    jf = (lambda x, y: x @ y) if fn == "matmul" else (
        lambda x, y: jnp.tanh(x @ y))
    tf = (lambda x, y: x @ y) if fn == "matmul" else (
        lambda x, y: torch.tanh(x @ y))
    want = jroof.roofline(jf, jnp.asarray(a), jnp.asarray(b))
    got = troof.roofline(tf, torch.from_numpy(a), torch.from_numpy(b),
                         step_time_s=1e-3)
    assert got.flops == want.flops
    assert got.transcendentals == want.transcendentals
    if fn == "matmul":
        assert got.bytes_accessed == want.bytes_accessed
    row = got.row()
    assert set(want.row()) <= set(row)
    assert row["step_ms"] == 1.0
    assert got.ridge == tprof.H100_PEAK_FLOPS / tprof.H100_PEAK_BYTES
    assert 0 < got.frac_of_roof <= 1


def test_peaks_are_the_h100s():
    assert tprof.H100_PEAK_FLOPS == 67e12 and tprof.H100_PEAK_BYTES == 3.35e12
    assert troof.H100_PEAK_FLOPS == tprof.H100_PEAK_FLOPS
    for mod in (tprof, troof):
        src = open(mod.__file__).read()
        assert "197e12" not in src and "819e9" not in src and "V5E" not in src


def test_time_fn_and_profile_trace(tmp_path):
    a, b = (torch.from_numpy(x) for x in _operands())
    seconds = tutils.time_fn(torch.mm, a, b, warmup=1, iters=3)
    assert 0 < seconds < 1
    with tutils.profile_trace(str(tmp_path / "trace")) as logdir:
        torch.mm(a, b)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_utils_exports_the_jax_names():
    for name in ("load_checkpoint", "save_checkpoint", "CheckpointManager",
                 "profile_trace", "time_fn"):
        assert hasattr(jutils, name) and hasattr(tutils, name), name
