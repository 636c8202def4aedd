"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, at the card's
full power limit of 700 W). A card not listed has no roofline."""

from __future__ import annotations

from typing import Optional

PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12}}

# bytes a value of each declared attribute type takes; a string is its id
WIDTHS = {"string": 4, "int": 4, "long": 8, "float": 4, "double": 8, "bool": 1}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)
