"""Fault tolerance for the port: ``coordinator`` (an own copy of
``repro/ft/coordinator.py``)."""
