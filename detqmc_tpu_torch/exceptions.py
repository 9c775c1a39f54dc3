"""Typed errors (reference parity: SURVEY.md §3 "Exceptions" —
ConfigurationError). The port's own copy of detqmc_tpu/exceptions.py, as
far as the port raises them."""

from __future__ import annotations


class ConfigurationError(ValueError):
    """Bad or inconsistent parameters (raised by the config module)."""
