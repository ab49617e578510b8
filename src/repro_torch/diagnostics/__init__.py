"""Diagnostics of the port: exact references on enumerable graphs
(``exact.py``)."""
