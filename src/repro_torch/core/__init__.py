"""Numeric formats and cache containers."""
