"""Serving: sampler, slot engine, request-lifecycle API."""
