"""Port parity: ``ssd_tpu_torch.serving.export`` — export → reload →
transcribe, held to the port engine and the JAX engine on the same weights,
the custom-op nodes the exported graph holds, and the artifact's guards
(buckets, platform, quantization), its CLI and a load in a fresh process."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ssd_tpu.data.vocab import default_vocab as jax_default_vocab
from ssd_tpu.serving import engine as jeng
from ssd_tpu_torch.data.vocab import default_vocab
from ssd_tpu_torch.serving import engine as teng
from ssd_tpu_torch.serving import export as texport
from ssd_tpu_torch.training.checkpoint import save_checkpoint

from .test_torch_logging import restored_logging
from .test_torch_streaming import CHANNELS, CONFIGS, shared_weights, tiny_cfg
from .torch_procs import no_stray_processes  # noqa: F401  (the fixture)

pytestmark = pytest.mark.usefixtures("no_stray_processes")

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BUCKET = 256  # the tiny featurizer config's raw-sample bucket
BATCHES = (1, 2)
NUM_LAYERS = 2
OPS = ("logmel_core", "attention_fwd", "depthwise_fwd")


@pytest.fixture(scope="module")
def weights():
    return shared_weights()


@pytest.fixture(scope="module")
def checkpoints(weights, tmp_path_factory):
    """A port checkpoint per configuration, on the same weights."""
    _, _, sd = weights
    out = {}
    for name, enc in CONFIGS.items():
        root = tmp_path_factory.mktemp(f"ckpt_{name}")
        default_vocab().to_json(root / "vocab.json")
        save_checkpoint(root / "run", sd, tiny_cfg(root / "vocab.json", **enc))
        out[name] = root / "run" / "last"
    return out


@pytest.fixture(scope="module")
def artifacts(checkpoints, tmp_path_factory):
    """Each configuration exported on the CPU at batches (1, 2) × 256 samples."""
    return {
        name: texport.export_checkpoint(ckpt, tmp_path_factory.mktemp(f"export_{name}"),
                                        batch_sizes=BATCHES, sample_lengths=(BUCKET,),
                                        device="cpu")
        for name, ckpt in checkpoints.items()
    }


@pytest.fixture
def small_buckets(monkeypatch):
    for mod in (jeng, teng):
        monkeypatch.setattr(mod, "SAMPLE_BUCKET", BUCKET)
        monkeypatch.setattr(mod, "BATCH_BUCKETS", BATCHES)


def _emg(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, CHANNELS)).astype(np.float32) for n in lengths]


def _op_counts(path: Path) -> dict:
    graph = torch.export.load(path).graph
    targets = [str(n.target) for n in graph.nodes if n.op == "call_function"]
    return {op: targets.count(f"ssd_tpu_torch.{op}.default") for op in OPS}


def test_artifact_layout(artifacts, checkpoints):
    for name, path in artifacts.items():
        manifest = json.loads((path / "manifest.json").read_text())
        assert (path / "vocab.json").exists()
        assert manifest["format"] == "ssd_tpu_torch.torch_export.v1"
        assert manifest["platforms"] == ["cpu"]
        assert manifest["torch_version"] == torch.__version__
        assert manifest["channels"] == CHANNELS
        assert manifest["checkpoint"] == str(checkpoints[name])
        assert (manifest["decoder"], manifest["quantize"]) == ("greedy", "none")
        assert manifest["sample_bucket"] == teng.SAMPLE_BUCKET == texport.SAMPLE_BUCKET
        assert [(b["batch"], b["samples"], b["file"]) for b in manifest["buckets"]] == [
            (1, BUCKET, "fn_b1_l256.pt2"), (2, BUCKET, "fn_b2_l256.pt2")]
        for b in manifest["buckets"]:
            assert (path / b["file"]).exists() and b["export_seconds"] > 0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_reload_matches_port_and_jax_engines(artifacts, weights, checkpoints, config,
                                             small_buckets):
    params, stats, _ = weights
    t = texport.ExportedTranscriber.load(artifacts[config], device="cpu")
    port = teng.InferenceEngine.from_checkpoint(checkpoints[config], device="cpu")
    jax_engine = jeng.InferenceEngine(tiny_cfg(**CONFIGS[config]), params, stats,
                                      jax_default_vocab())
    for reqs in (_emg(0, 180), _emg(1, 240, 130)):
        got = t.transcribe(reqs)
        assert got == port.transcribe(reqs) == jax_engine.transcribe(reqs)
        assert len(got) == len(reqs) and any(got)
    # the tokens are the port engine's greedy tokens, bit for bit
    reqs = _emg(2, 200, 256)
    tokens, counts = t.call(reqs)
    with torch.no_grad():
        want_tokens, want_counts = texport.BucketProgram(port, 0.0)(
            *(torch.from_numpy(a) for a in port._pad(reqs)))
    np.testing.assert_array_equal(counts, want_counts.numpy())
    np.testing.assert_array_equal(tokens, want_tokens.numpy())


@pytest.mark.parametrize("config", list(CONFIGS))
def test_graph_holds_the_custom_ops(artifacts, config):
    """One log-mel node; one attention- and one depthwise-forward node a
    block under fused/pallas, none under the defaults — and no aten
    version of the kernels baked in in their place."""
    per_block = NUM_LAYERS if config == "fused" else 0
    for b in BATCHES:
        counts = _op_counts(artifacts[config] / f"fn_b{b}_l{BUCKET}.pt2")
        assert counts == {"logmel_core": 1, "attention_fwd": per_block,
                          "depthwise_fwd": per_block}


def test_bucket_overflow_raises(artifacts):
    t = texport.ExportedTranscriber.load(artifacts["default"], device="cpu")
    with pytest.raises(ValueError, match="no exported bucket"):
        t.transcribe(_emg(3, BUCKET + 1))
    with pytest.raises(ValueError, match="no exported bucket"):
        t.transcribe(_emg(3, 100, 100, 100))
    with pytest.raises(ValueError, match="expected"):
        t.transcribe([np.zeros((100, CHANNELS + 1), np.float32)])


def test_platform_mismatch_raises(artifacts, tmp_path):
    copy = tmp_path / "foreign"
    shutil.copytree(artifacts["default"], copy)
    manifest = json.loads((copy / "manifest.json").read_text())
    manifest["platforms"] = ["cuda"]
    (copy / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(RuntimeError, match="platform-locked"):
        texport.ExportedTranscriber.load(copy, device="cpu")


def test_cuda_export_and_load_raise_without_a_card(artifacts, checkpoints, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.ExportedTranscriber.load(artifacts["default"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        texport.export_checkpoint(checkpoints["default"], tmp_path / "out")


def test_cli(checkpoints, tmp_path, small_buckets):
    out = tmp_path / "artifact"
    with restored_logging():
        texport.main(["--checkpoint", str(checkpoints["fused"]), "--out", str(out),
                      "--batch-sizes", "1", "--sample-lengths", str(BUCKET), "--device", "cpu",
                      "--blank-bias", "0.5"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["blank_bias"] == 0.5 and len(manifest["buckets"]) == 1
    t = texport.ExportedTranscriber.load(out, device="cpu")
    reqs = _emg(4, 200)
    port = teng.InferenceEngine.from_checkpoint(checkpoints["fused"], device="cpu",
                                                blank_bias=0.5)
    assert t.transcribe(reqs) == port.transcribe(reqs)


@pytest.mark.parametrize("mode", ["int8", "int8_prequant"])
def test_quantize_raises(checkpoints, tmp_path, mode):
    """A quantized export records its mode, serves the quantized engine's
    tokens, and — like every artifact — raises when loaded on another
    platform than the one it was exported on."""
    out = tmp_path / "q"
    with restored_logging():
        texport.main(["--checkpoint", str(checkpoints["default"]), "--out", str(out),
                      "--batch-sizes", "4", "--sample-lengths", str(BUCKET), "--device", "cpu",
                      "--quantize", mode])
    assert json.loads((out / "manifest.json").read_text())["quantize"] == mode
    t = texport.ExportedTranscriber.load(out, device="cpu")
    reqs = _emg(4, 200)
    port = teng.InferenceEngine.from_checkpoint(checkpoints["default"], device="cpu",
                                                quantize=mode)
    assert t.transcribe(reqs) == port.transcribe(reqs)
    with pytest.raises(RuntimeError):
        texport.ExportedTranscriber.load(out, device="cuda")


_FRESH = r"""
import sys
import numpy as np
import ssd_tpu_torch.serving.export as export
t = export.ExportedTranscriber.load(sys.argv[1], device="cpu")
print(t.transcribe([np.load(sys.argv[2])])[0])
print(sorted(m for m in sys.modules if m.startswith(("ssd_tpu_torch.models",
      "ssd_tpu_torch.training", "ssd_tpu_torch.serving.engine", "jax", "ssd_tpu."))))
"""


def test_loads_in_a_fresh_process(artifacts, checkpoints, tmp_path, small_buckets):
    """A process that imports only ``ssd_tpu_torch.serving.export`` serves
    the artifact, and imports no model, training or engine code for it."""
    (emg,) = _emg(5, 230)
    np.save(tmp_path / "emg.npy", emg)
    proc = subprocess.run(
        [sys.executable, "-c", _FRESH, str(artifacts["fused"]), str(tmp_path / "emg.npy")],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)),
    )
    assert proc.returncode == 0, proc.stderr
    text, imported = proc.stdout.rstrip("\n").split("\n")[-2:]
    port = teng.InferenceEngine.from_checkpoint(checkpoints["fused"], device="cpu")
    assert text == port.transcribe([emg])[0]
    assert imported == "[]"
