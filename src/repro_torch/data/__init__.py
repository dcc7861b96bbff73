"""Procedural data pipelines of the port (numpy only)."""
