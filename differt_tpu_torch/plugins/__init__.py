"""Plugins: exporters to other frameworks."""

from . import deepmimo

__all__ = ("deepmimo",)
