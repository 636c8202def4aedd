"""Annotations attached to app/definitions/queries.

Mirrors reference ``query-api annotation/Annotation.java`` — a name plus
ordered key/value elements plus nested annotations (``@map`` inside
``@source`` etc.).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Annotation:
    name: str
    # Ordered (key, value) pairs; key may be None for positional elements.
    elements: List[tuple] = field(default_factory=list)
    annotations: List["Annotation"] = field(default_factory=list)

    def element(self, key: Optional[str] = None) -> Optional[str]:
        """Value for `key`; with key=None, the first positional value."""
        for k, v in self.elements:
            if k == key or (key is None and k is None):
                return v
        return None

    def elements_map(self) -> Dict[Optional[str], str]:
        return {k: v for k, v in self.elements}

    def annotation(self, name: str) -> Optional["Annotation"]:
        for a in self.annotations:
            if a.name.lower() == name.lower():
                return a
        return None


def find_annotation(annotations: List[Annotation], name: str) -> Optional[Annotation]:
    for a in annotations:
        if a.name.lower() == name.lower():
            return a
    return None


def find_annotations(annotations: List[Annotation], name: str) -> List[Annotation]:
    return [a for a in annotations if a.name.lower() == name.lower()]
