"""The port stands alone: importing every ``ssd_tpu_torch`` module and
``chip_smoke`` pulls in neither JAX (nor flax, optax, orbax) nor any module
of ``ssd_tpu``, and none of the packages the card machine lacks (``yaml``,
``pandas``, ``tensorboardX``, ``safetensors``, ``transformers``,
``huggingface_hub``, ``ml_dtypes``): the port reads YAML and safetensors
itself, imports pandas and tensorboardX lazily, and needs none of the
rest."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import ssd_tpu_torch
names = ["ssd_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(ssd_tpu_torch.__path__, "ssd_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
missing = [m for m in ("ssd_tpu_torch.parallel.mesh", "ssd_tpu_torch.parallel.partition",
                       "ssd_tpu_torch.parallel.collectives", "ssd_tpu_torch.parallel.replicas")
           if m not in names]
assert not missing, missing
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "pandas", "tensorboardX",
                           "safetensors", "transformers", "huggingface_hub", "ml_dtypes")
    or m == "ssd_tpu"
    or m.startswith("ssd_tpu.")
)
print(len(names))
print(bad)
"""


def test_port_imports_no_jax_and_no_ssd_tpu():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    n_modules, bad = proc.stdout.strip().splitlines()[-2:]
    assert int(n_modules) >= 56  # the package, its 9 subpackages and 46 modules
    assert bad == "[]", f"the port imported {bad}"
