"""Compute ops: color conversion, resize tables, classical resize."""

from . import color, filters, resize, weights_table  # noqa: F401
