"""Config loading + CLI logging set-up (the port's own copy of the parts of
``ssd_tpu/utils/config.py`` it uses).

``yaml`` is imported inside :func:`load_config` only: the package and
``chip_smoke.py`` must import on machines without ``pyyaml``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Any, Dict


def setup_cli_logging() -> None:
    """INFO logging for the port's CLIs."""
    logging.basicConfig(
        level=logging.INFO, format="%(levelname)s: %(message)s", force=True
    )


def load_config(path: Path | str) -> Dict[str, Any]:
    """Read a YAML (or JSON, which YAML parses) config file."""
    import yaml

    with Path(path).open("r") as f:
        return yaml.safe_load(f)
