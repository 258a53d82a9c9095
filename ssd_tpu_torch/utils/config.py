"""Config loading + CLI logging set-up (the port's own copy of the parts of
``ssd_tpu/utils/config.py`` it uses).

A ``.json`` config is read with :mod:`json`, so the CLIs run where
``pyyaml`` is not installed; anything else is read as YAML, with ``yaml``
imported inside :func:`load_config` only.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict


def setup_cli_logging() -> None:
    """INFO logging for the port's CLIs."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s: %(message)s", force=True
    )


def load_config(path: Path | str) -> Dict[str, Any]:
    """Read a JSON (``.json``) or YAML config file."""
    path = Path(path)
    if path.suffix.lower() == ".json":
        return json.loads(path.read_text())
    import yaml

    with path.open("r") as f:
        return yaml.safe_load(f)
