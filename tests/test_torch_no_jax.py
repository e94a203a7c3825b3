"""The port and chip_smoke.py import neither JAX nor the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of these now fails
import geometric_message_passing_tpu_torch as pkg
names = [pkg.__name__]
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke                    # module level only; main() is not run
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] == "geometric_message_passing_tpu")
print(json.dumps({"imported": names, "jax_package": loaded}))
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["jax_package"] == []
    for module in ("geometric_message_passing_tpu_torch.graph",
                   "geometric_message_passing_tpu_torch.datasets",
                   "geometric_message_passing_tpu_torch.ops.edge",
                   "geometric_message_passing_tpu_torch.ops._build",
                   "geometric_message_passing_tpu_torch.models.egnn_fused",
                   "geometric_message_passing_tpu_torch.weights",
                   "geometric_message_passing_tpu_torch.experiments.infer",
                   "geometric_message_passing_tpu_torch.experiments.train",
                   "geometric_message_passing_tpu_torch.experiments.bench",
                   "geometric_message_passing_tpu_torch.experiments.profile_train",
                   "geometric_message_passing_tpu_torch.experiments.bench_scale",
                   "geometric_message_passing_tpu_torch.ops.radius_graph",
                   "geometric_message_passing_tpu_torch.ops.norms",
                   "geometric_message_passing_tpu_torch.ops.radial",
                   "geometric_message_passing_tpu_torch.ops.sorted_segsum",
                   "geometric_message_passing_tpu_torch.nn.basic",
                   "geometric_message_passing_tpu_torch.models.egnn",
                   "geometric_message_passing_tpu_torch.models.schnet",
                   "geometric_message_passing_tpu_torch.nn.gvp",
                   "geometric_message_passing_tpu_torch.ops.gvp_message",
                   "geometric_message_passing_tpu_torch.models.gvpgnn",
                   "geometric_message_passing_tpu_torch.experiments.trial_gvp",
                   "geometric_message_passing_tpu_torch.experiments.profile_box",
                   "geometric_message_passing_tpu_torch.ops.egnn_stack",
                   "geometric_message_passing_tpu_torch.experiments.bench_throughput",
                   "geometric_message_passing_tpu_torch.irreps",
                   "geometric_message_passing_tpu_torch.ops.spherical",
                   "geometric_message_passing_tpu_torch.ops.scatter",
                   "geometric_message_passing_tpu_torch.ops.edge_contract",
                   "geometric_message_passing_tpu_torch.nn.equivariant",
                   "geometric_message_passing_tpu_torch.nn.tensor_product",
                   "geometric_message_passing_tpu_torch.nn.conv",
                   "geometric_message_passing_tpu_torch.models.tfn",
                   "geometric_message_passing_tpu_torch.experiments.trial_gvp_drift",
                   "geometric_message_passing_tpu_torch.experiments.bench_kernels",
                   "geometric_message_passing_tpu_torch.triplets",
                   "geometric_message_passing_tpu_torch.ops.dimenet_basis",
                   "geometric_message_passing_tpu_torch.models.dimenet",
                   "geometric_message_passing_tpu_torch.models.spherenet",
                   "geometric_message_passing_tpu_torch.transforms",
                   "geometric_message_passing_tpu_torch.nn.symmetric_contraction",
                   "geometric_message_passing_tpu_torch.models.mace",
                   "geometric_message_passing_tpu_torch.examples",
                   "geometric_message_passing_tpu_torch.examples.kchains",
                   "geometric_message_passing_tpu_torch.examples.rotsym",
                   "geometric_message_passing_tpu_torch.examples.incompleteness",
                   "geometric_message_passing_tpu_torch.nn.mace_blocks",
                   "geometric_message_passing_tpu_torch.models.mace_ff",
                   "geometric_message_passing_tpu_torch.models.tfn_ff",
                   "geometric_message_passing_tpu_torch.entry",
                   "geometric_message_passing_tpu_torch.experiments.cli",
                   "geometric_message_passing_tpu_torch.experiments.ledger",
                   "geometric_message_passing_tpu_torch.experiments.seed_spread",
                   "geometric_message_passing_tpu_torch.utils",
                   "geometric_message_passing_tpu_torch.utils.checkpoint",
                   "geometric_message_passing_tpu_torch.utils.debug",
                   "geometric_message_passing_tpu_torch.utils.plot",
                   "geometric_message_passing_tpu_torch.utils.profiler",
                   "geometric_message_passing_tpu_torch.utils.roofline",
                   "geometric_message_passing_tpu_torch.models.gnn101",
                   "geometric_message_passing_tpu_torch.examples.gnn101",
                   "geometric_message_passing_tpu_torch.examples.qm9_pipeline",
                   "geometric_message_passing_tpu_torch.examples.make_101_notebook",
                   "geometric_message_passing_tpu_torch.examples.make_experiment_notebooks",
                   "geometric_message_passing_tpu_torch.parallel",
                   "geometric_message_passing_tpu_torch.parallel.mesh",
                   "geometric_message_passing_tpu_torch.parallel.launch",
                   "geometric_message_passing_tpu_torch.parallel.data",
                   "geometric_message_passing_tpu_torch.parallel.zero",
                   "geometric_message_passing_tpu_torch.experiments.dp_fit",
                   "geometric_message_passing_tpu_torch.experiments.probe_backends",
                   "geometric_message_passing_tpu_torch.experiments.dp_check",
                   "geometric_message_passing_tpu_torch.experiments.dp_drift",
                   "geometric_message_passing_tpu_torch.parallel.tp",
                   "geometric_message_passing_tpu_torch.parallel.pp",
                   "geometric_message_passing_tpu_torch.experiments.tp_check",
                   "geometric_message_passing_tpu_torch.parallel.halo",
                   "geometric_message_passing_tpu_torch.parallel.partition",
                   "geometric_message_passing_tpu_torch.experiments.gp_check",
                   "geometric_message_passing_tpu_torch.experiments."
                   "dryrun_multichip",
                   "geometric_message_passing_tpu_torch.precision",
                   "geometric_message_passing_tpu_torch.native",
                   "geometric_message_passing_tpu_torch.native.batch",
                   "geometric_message_passing_tpu_torch.ops._host_build",
                   "geometric_message_passing_tpu_torch.experiments."
                   "precision_check",
                   "geometric_message_passing_tpu_torch.experiments."
                   "staged_check",
                   "geometric_message_passing_tpu_torch.experiments."
                   "validate_accuracy",
                   "geometric_message_passing_tpu_torch.experiments."
                   "roofline_report",
                   "geometric_message_passing_tpu_torch.experiments."
                   "roofline_scale",
                   "geometric_message_passing_tpu_torch.experiments."
                   "halo_box_stats",
                   "geometric_message_passing_tpu_torch.experiments."
                   "bench_scaling"):
        assert module in res["imported"]


def test_port_sources_do_not_name_jax():
    files = list((ROOT / "geometric_message_passing_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for line in f.read_text().splitlines():
            words = line.replace(",", " ").split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1]
                assert mod.split(".")[0] not in ("jax", "flax", "optax"), f
                assert mod.split(".")[0] != "geometric_message_passing_tpu", f
