"""Guarded-by field contracts.

Counterpart of ``siddhi_tpu/analysis/guards.py`` in the form the reference
runs with its sanitizer off: a class declares ``GUARDED_BY = {field:
lock rank}`` next to its state, and ``guarded(cls)`` returns the class
untouched. The checking descriptors and the rank validation against the
lock-order table are ROADMAP A.10.
"""

from __future__ import annotations


def guarded(cls):
    """Class decorator: the class must declare ``GUARDED_BY`` of its own;
    returns it unchanged."""
    if cls.__dict__.get("GUARDED_BY", None) is None:
        raise ValueError(
            f"@guarded class {cls.__name__} has no GUARDED_BY "
            f"declaration of its own")
    return cls
