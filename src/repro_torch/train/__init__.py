"""Training for the port, on one card or data-parallel across ranks:
``state``, ``optimizer``, ``step`` and ``loop``, the counterparts of
``repro/train``."""
