"""Checkpoints of the port: atomic, manifest-driven, integrity-checked
(``checkpoint``)."""
