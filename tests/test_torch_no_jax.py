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
                   "geometric_message_passing_tpu_torch.experiments.infer"):
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
