"""Colored, truncating console logging (replaces the reference's
LoggerMixin/FancyFormatter/init_fancy_logging, cbctmc/logger.py). The
port's copy of the JAX package's ``utils/logging.py``."""

from __future__ import annotations

import logging
import sys

LEVEL_COLORS = {
    logging.DEBUG: "\x1b[38;21m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33;1m",
    logging.ERROR: "\x1b[31;1m",
    logging.CRITICAL: "\x1b[41;1m",
}
RESET = "\x1b[0m"


class FancyFormatter(logging.Formatter):
    """Per-level colors and optional message truncation."""

    def __init__(self, max_message_length: int | None = None, colors: bool = True):
        super().__init__()
        self.max_message_length = max_message_length
        self.colors = colors and sys.stderr.isatty()

    def format(self, record: logging.LogRecord) -> str:
        message = record.getMessage()
        if self.max_message_length and len(message) > self.max_message_length:
            message = message[: self.max_message_length - 3] + "..."
        prefix = f"{self.formatTime(record, '%Y-%m-%d %H:%M:%S')} "
        level = f"{record.levelname:<8}"
        if self.colors:
            level = LEVEL_COLORS.get(record.levelno, "") + level + RESET
        return f"{prefix}{level} {record.name}: {message}"


class LoggerMixin:
    """Adds a per-class ``self.logger``."""

    @property
    def logger(self) -> logging.Logger:
        return logging.getLogger(
            f"{type(self).__module__}.{type(self).__qualname__}"
        )


def init_fancy_logging(
    level: int = logging.INFO, max_message_length: int | None = None
):
    handler = logging.StreamHandler()
    handler.setFormatter(FancyFormatter(max_message_length=max_message_length))
    root = logging.getLogger()
    root.handlers = [handler]
    root.setLevel(level)
