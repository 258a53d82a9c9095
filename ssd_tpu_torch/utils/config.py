"""Config loading, saving and merging + CLI logging set-up (the port's own
copy of ``ssd_tpu/utils/config.py``).

A ``.json`` config is read and written with :mod:`json`; anything else is
YAML, read and written by the port's own code for the subset the shipped
configs use (:mod:`ssd_tpu_torch.utils.yaml_subset`), so the CLIs read the
shipped YAML configs where ``pyyaml`` is not installed.
"""

from __future__ import annotations

import copy
import json
import logging
from pathlib import Path
from typing import Any, Dict

from ssd_tpu_torch.utils.yaml_subset import read_yaml, write_yaml


def setup_cli_logging() -> None:
    """INFO logging for the port's CLIs."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s: %(message)s", force=True
    )


def load_config(path: Path | str) -> Dict[str, Any]:
    """Read a JSON (``.json``) or YAML config file; YAML outside the subset
    raises ``ValueError`` naming the file and line."""
    path = Path(path)
    if path.suffix.lower() == ".json":
        return json.loads(path.read_text())
    return read_yaml(path.read_text(), str(path))


def save_config(cfg: Dict[str, Any], path: Path | str) -> None:
    """Write ``cfg`` where :func:`load_config` reads it back: JSON (indent 2,
    as the JAX package writes every config) for ``.json``, block YAML
    otherwise."""
    path = Path(path)
    if path.suffix.lower() == ".json":
        path.write_text(json.dumps(cfg, indent=2))
    else:
        path.write_text(write_yaml(cfg))


def deep_update(base: Dict[str, Any], overrides: Dict[str, Any]) -> Dict[str, Any]:
    """Recursive dict merge returning a new dict: a dict in ``overrides``
    merges into a dict of ``base``, anything else replaces it (copied)."""
    out = copy.deepcopy(base)
    for key, val in overrides.items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = deep_update(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out
