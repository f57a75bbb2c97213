"""Single-card training for the port: ``state``, ``optimizer``, ``step``
and ``loop``, the counterparts of ``repro/train``."""
