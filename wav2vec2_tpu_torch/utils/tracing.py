"""Logging configuration helper.

The reference uses the `tracing` crate with NO subscriber installed by the
library — the caller chooses (SURVEY.md §5). Same discipline here: modules
log through `logging.getLogger(__name__)` and never configure handlers;
applications (the CLI) call `configure_logging` once.
"""

from __future__ import annotations

import logging
import os


def configure_logging(level: str | int | None = None) -> None:
    """Install a stderr handler for the framework's loggers. Level defaults
    to $WAV2VEC2_TPU_LOG (warning if unset). The port's loggers live under
    `wav2vec2_tpu_torch`, which is not a child of the JAX package's logger."""
    if level is None:
        level = os.environ.get("WAV2VEC2_TPU_LOG", "WARNING")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.WARNING)
    root = logging.getLogger("wav2vec2_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
        )
        root.addHandler(handler)
    root.setLevel(level)
