"""The port stands alone: importing every ``ssd_tpu_torch`` module and
``chip_smoke`` pulls in neither JAX (nor flax, optax, orbax) nor any module
of ``ssd_tpu``, and none of the packages the card machine lacks (``yaml``,
``pandas``, ``tensorboardX``, ``safetensors``, ``transformers``,
``huggingface_hub``, ``ml_dtypes``, ``matplotlib``, ``umap``): the port
reads and writes YAML and reads safetensors itself, imports pandas,
tensorboardX, matplotlib and umap lazily, and needs none of the rest."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

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
                       "ssd_tpu_torch.parallel.collectives", "ssd_tpu_torch.parallel.replicas",
                       "ssd_tpu_torch.experiments.config_builder",
                       "ssd_tpu_torch.experiments.orchestrate",
                       "ssd_tpu_torch.training.average_checkpoints",
                       "ssd_tpu_torch.evaluation.visualize")
           if m not in names]
assert not missing, missing
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "pandas", "tensorboardX",
                           "safetensors", "transformers", "huggingface_hub", "ml_dtypes",
                           "matplotlib", "umap")
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
    assert int(n_modules) >= 61  # the package, its 10 subpackages and 50 modules
    assert bad == "[]", f"the port imported {bad}"
