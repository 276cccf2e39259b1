"""Logging for the port: the JAX package's logger naming (``tfk8s.<name>``),
so the port's trainer logs read like the reference's."""

from __future__ import annotations

import logging


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"tfk8s.{name}")
