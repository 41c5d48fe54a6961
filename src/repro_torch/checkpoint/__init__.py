"""Atomic, resumable checkpoints (``manager``)."""
