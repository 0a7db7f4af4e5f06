"""Streaming steps: fixed-shape chunk steps over a leading stream axis."""
