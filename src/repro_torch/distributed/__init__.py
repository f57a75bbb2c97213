"""Gradient compression, the single-device half of
``repro/distributed/compression.py``."""
