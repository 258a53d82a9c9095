"""The port's CLIs set up INFO logging on the root logger
(``setup_cli_logging``: ``basicConfig(level=INFO, force=True)``), which
outlives the call. :func:`restored_logging` puts the root logger's level and
handlers back after a test calls a port ``main()``, so that no later test in
the same process sees another test's logging set-up."""

import contextlib
import logging

from ssd_tpu_torch.utils.config import setup_cli_logging


@contextlib.contextmanager
def restored_logging():
    """Run the body, then restore the root logger's level and handlers."""
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    try:
        yield
    finally:
        for h in root.handlers:
            if h not in handlers:
                root.removeHandler(h)
                h.close()
        for h in handlers:
            if h not in root.handlers:
                root.addHandler(h)
        root.setLevel(level)


def test_restored_logging_undoes_the_cli_set_up():
    root = logging.getLogger()
    level, handlers = root.level, list(root.handlers)
    with restored_logging():
        setup_cli_logging()
        assert root.level == logging.INFO
        assert root.handlers != handlers
    assert root.level == level
    assert root.handlers == handlers


def test_restored_logging_restores_after_an_error():
    root = logging.getLogger()
    level = root.level
    try:
        with restored_logging():
            root.setLevel(logging.DEBUG)
            raise KeyError("x")
    except KeyError:
        pass
    assert root.level == level
