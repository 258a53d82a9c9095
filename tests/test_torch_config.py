"""The port's YAML reader (``ssd_tpu_torch/utils/yaml_subset.py``) against
``yaml.safe_load``: every shipped config, the YAML 1.1 scalar rules the
configs lean on, the constructs outside the subset, and a config read and
built where ``yaml`` cannot be imported (as on the card machine)."""

import sys
from pathlib import Path

import pytest
import torch

from ssd_tpu_torch.models.ssd_model import build_model
from ssd_tpu_torch.training.schedules import build_optimizer
from ssd_tpu_torch.utils.config import load_config
from ssd_tpu_torch.utils.yaml_subset import read_yaml

yaml = pytest.importorskip("yaml")

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted((REPO / "configs").glob("*.yaml")) + sorted(
    (REPO / "configs" / "experiments").glob("*.yaml"))


def test_every_shipped_config_is_collected():
    assert len(SHIPPED) == 12


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: str(p.relative_to(REPO)))
def test_load_config_equals_safe_load_on_shipped_yaml(path):
    assert load_config(path) == yaml.safe_load(path.read_text())


def test_yaml11_float_needs_a_dot():
    text = "lr: 3e-4\nwd: 7.5e-3\nwd2: 1.0e-2\nunsigned: 1.0e2\nwarm: 1e-2\n"
    got = read_yaml(text)
    assert got == yaml.safe_load(text)
    assert got["lr"] == "3e-4" and got["warm"] == "1e-2" and got["unsigned"] == "1.0e2"
    assert isinstance(got["wd"], float) and got["wd"] == 7.5e-3 and got["wd2"] == 1.0e-2


@pytest.mark.parametrize(
    "text",
    [
        "a: 010\nb: 0x1F\nc: 0b11\nd: -0\ne: 09\nf: 1_000\ng: +12\nh: .5\ni: 1.\nj: -.inf\n",
        "a: yes\nb: On\nc: NO\nd: off\ne: ~\nf: null\ng:\nh: True\ni: yEs\n",
        "a: 'it''s'\nb: \"t q # r\"\nc: 'x: y'\n\"q k\": 2\nd: a#b\ne: x # c\n",
        "a: [1, 'x', {b: c}]\nd: {e: [1, 2], f: }\ng: [h, i, ]\nj: {k}\nl: {m: 'n # o'} # p\n",
        "- a\n- - b\n  - c\n- d: 1\n  e: [2]\n-\n  f: 3\n-\n",
        "k:\n- 1\n- 2\nl:   # c\n  m: 1\n",
        "---\na: 1\n",
        "[1, 2]\n",
        "",
    ],
)
def test_read_yaml_equals_safe_load_on_the_subset(text):
    assert read_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize(
    "text,line,what",
    [
        ("a: 1\nb: &anchor 2\n", 2, "anchor"),
        ("a: 1\nb: *alias\n", 2, "alias"),
        ("a: !!float 1\n", 1, "tag"),
        ("a:\n  b: |\n    text\n", 2, "block scalar"),
        ("a: >\n  text\n", 1, "block scalar"),
        ("a: 1\n---\nb: 2\n", 2, "several documents"),
        ("a: [1,\n  2]\n", 1, "does not close"),
        ("a: b\n  c\n", 2, "unexpected indentation"),
        ("a: 1:30\n", 1, "sexagesimal"),
        ("a: b\nc: \"t\\tq\"\n", 2, "escape"),
    ],
)
def test_outside_the_subset_raises_with_file_and_line(tmp_path, text, line, what):
    path = tmp_path / "bad.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"bad\.yaml:{line}: .*{what}"):
        load_config(path)


def test_configs_load_and_build_without_yaml(tmp_path, monkeypatch):
    """With ``yaml`` unimportable, a shipped config still loads, and a tiny
    config written as YAML builds a model and an optimizer with its
    ``lr: 3e-4`` string coerced."""
    shipped = REPO / "configs" / "tpu_fast_plus.yaml"
    want = yaml.safe_load(shipped.read_text())
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    assert load_config(shipped) == want
    tiny = tmp_path / "tiny.yaml"
    tiny.write_text(
        "model:\n"
        "  encoder: {d_model: 48, num_layers: 2, num_heads: 4, ffn_dim: 96,\n"
        "            depthwise_conv_kernel_size: 5, dropout: 0.0, subsample_factor: 2}\n"
        "  projection_dim: 32\n"
        "optim:\n"
        "  lr: 3e-4  # a string under YAML 1.1\n"
        "  weight_decay: 1e-2\n"
        "  clip_grad_norm: 5.0\n"
        "  scheduler: {name: warmup_hold, warmup_steps: 4}\n"
    )
    with pytest.raises(ValueError, match="tiny.yaml:2: .*does not close"):
        load_config(tiny)
    tiny.write_text(tiny.read_text().replace(",\n            ", ", "))
    cfg = load_config(tiny)
    assert cfg["optim"]["lr"] == "3e-4" and cfg["optim"]["weight_decay"] == "1e-2"
    model = build_model(cfg, input_dim=16, vocab_size=48)
    opt, schedule = build_optimizer(cfg, model.parameters(), 10)
    assert opt.adamw.param_groups[0]["weight_decay"] == pytest.approx(1e-2)
    assert schedule(4) == pytest.approx(3e-4)
    log_probs, out_lengths, _ = model(torch.zeros((1, 20, 16)), torch.tensor([20]))
    assert log_probs.shape == (1, 10, 48) and int(out_lengths[0]) == 10
    assert bool(torch.isfinite(log_probs).all())
