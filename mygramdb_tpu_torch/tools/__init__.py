"""Probes and measurement tools of the port (run with ``python -m``)."""
