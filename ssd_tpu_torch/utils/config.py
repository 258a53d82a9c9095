"""Config loading + CLI logging set-up (the port's own copy of the parts of
``ssd_tpu/utils/config.py`` it uses).

A ``.json`` config is read with :mod:`json`; anything else is read as YAML
by the port's own reader of the subset the shipped configs use
(:mod:`ssd_tpu_torch.utils.yaml_subset`), so the CLIs read the shipped YAML
configs where ``pyyaml`` is not installed.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict

from ssd_tpu_torch.utils.yaml_subset import read_yaml


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
