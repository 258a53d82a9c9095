"""``tests/torch_jax_native.py`` against the native-build race of the JAX
package's loader (``ssd_tpu/utils/native.py``), on a copy of the loader and
of ``native/`` in a temporary tree (the repo's ``native/`` is not touched):

* a truncated ``libssd_native.so`` leaves the copied loader at ``None`` with
  "file too short" for the rest of the process; after ``jax_native`` the
  same process decodes a FLAC file to the encoder's samples;
* six processes started together on a tree with no library, each through
  ``jax_native``, all decode, and build the library once between them;
* the helper's FLAC encoder writes the bytes of ``tests/test_native.py``'s.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from .torch_jax_native import encode_flac
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

REPO = Path(__file__).resolve().parents[1]
PROCESSES = 6

_CHILD = r"""
import json, logging, os, sys
tree, tests, flac, probe_first = sys.argv[1:5]
sys.path[:0] = [tree, tests]

class Keep(logging.Handler):
    messages = []
    def emit(self, record):
        self.messages.append(record.getMessage())

logging.getLogger().addHandler(Keep())
import numpy as np
from ssd_tpu.utils import native
from ssd_tpu.data.flac import decode_flac
import torch_jax_native

assert native.__file__.startswith(tree), native.__file__
before = native.load() is None if probe_first == "1" else None
torch_jax_native.jax_native(native)
audio, sr = decode_flac(flac)
print(json.dumps({"none_before": before, "warnings": Keep.messages, "sr": sr,
                  "samples": np.round(audio * 32768).astype(int).tolist(),
                  "inode": os.stat(native._SO_PATH).st_ino}))
"""


def _tree(root: Path) -> Path:
    """The loader, the FLAC module and ``native/``'s sources, laid out as in
    the repo so the loader finds ``native/`` from its own path."""
    for pkg in ("ssd_tpu", "ssd_tpu/utils", "ssd_tpu/data"):
        (root / pkg).mkdir(parents=True, exist_ok=True)
        (root / pkg / "__init__.py").write_text("")
    shutil.copy(REPO / "ssd_tpu/utils/native.py", root / "ssd_tpu/utils/native.py")
    shutil.copy(REPO / "ssd_tpu/data/flac.py", root / "ssd_tpu/data/flac.py")
    (root / "native").mkdir()
    for name in ("Makefile", "flac_decoder.cpp", "edit_distance.cpp"):
        shutil.copy(REPO / "native" / name, root / "native" / name)
    return root


def _flac(path: Path, seed: int) -> np.ndarray:
    data = np.random.default_rng(seed).integers(-20000, 20000, size=700).astype(np.int32)
    path.write_bytes(encode_flac([data], mode="fixed2"))
    return data


def _start(tree: Path, flac: Path, probe_first: bool) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(tree), str(REPO / "tests"), str(flac),
         "1" if probe_first else "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _results(procs) -> list:
    """Each process's JSON line, once every process has exited."""
    done = [(p.communicate(timeout=120), p.returncode) for p in procs]
    for (_, err), rc in done:
        assert rc == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for (out, _), _ in done]


def test_truncated_library_is_repaired_in_the_same_process(tmp_path):
    tree = _tree(tmp_path / "tree")
    # the first bytes of an ELF file: what a reader sees mid-link
    (tree / "native" / "libssd_native.so").write_bytes(b"\x7fELF\x02\x01\x01" + bytes(25))
    data = _flac(tmp_path / "a.flac", seed=0)
    (got,) = _results([_start(tree, tmp_path / "a.flac", probe_first=True)])
    assert got["none_before"] is True
    assert any("file too short" in m for m in got["warnings"]), got["warnings"]
    assert got["sr"] == 16000
    np.testing.assert_array_equal(got["samples"], data)


def test_six_processes_at_once_all_decode(tmp_path):
    tree = _tree(tmp_path / "tree")
    data = _flac(tmp_path / "a.flac", seed=1)
    procs = [_start(tree, tmp_path / "a.flac", probe_first=False) for _ in range(PROCESSES)]
    results = _results(procs)
    for got in results:
        np.testing.assert_array_equal(got["samples"], data)
    # one build: every later process loaded the first one's file as it was
    assert len({got["inode"] for got in results}) == 1
    assert not list((tree / "native").glob("*.tmp"))


def _reference_encoder():
    """``tests/test_native.py``'s ``_BitWriter`` and ``_encode_flac``, run
    without importing that module (its import loads the native library)."""
    source = (REPO / "tests" / "test_native.py").read_text()
    keep = [node for node in ast.parse(source).body
            if isinstance(node, (ast.ClassDef, ast.FunctionDef))
            and node.name in ("_BitWriter", "_encode_flac")]
    namespace = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "test_native.py", "exec"), namespace)
    return namespace["_encode_flac"]


@pytest.mark.parametrize("mode", ["verbatim", "constant", "fixed2"])
def test_encoder_writes_the_reference_tests_bytes(mode):
    reference = _reference_encoder()
    rng = np.random.default_rng(3)
    channels = [rng.integers(-30000, 30000, size=300).astype(np.int32) for _ in range(2)]
    for data, sr in (([channels[0]], 16000), (channels, 22050)):
        assert encode_flac(data, sample_rate=sr, mode=mode) == reference(data, sample_rate=sr,
                                                                          mode=mode)
