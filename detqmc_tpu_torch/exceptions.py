"""Typed errors (reference parity: SURVEY.md §3 "Exceptions" —
ConfigurationError). The port's own copy of detqmc_tpu/exceptions.py, as
far as the port raises them."""

from __future__ import annotations


class GeneralError(RuntimeError):
    """Runtime failure not attributable to configuration (raised by the
    analysis tools, e.g. reweighting before the free-energy solve)."""


class ConfigurationError(ValueError):
    """Bad or inconsistent parameters (raised by the config module)."""
