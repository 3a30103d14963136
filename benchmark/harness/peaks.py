"""Published peaks of the cards the benchmark knows, by a part of the name
that ``torch.cuda.get_device_name()`` gives.

NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; outside the tensor cores
34 TFLOP/s in float64 and 67 TFLOP/s in float32.  These assume the card's
full power limit of 700 W; the run reports the limit it found beside every
share of a peak.
"""

from __future__ import annotations

from typing import NamedTuple


class Peaks(NamedTuple):
    hbm_bytes_per_s: float
    flops: dict  # dtype name ("float64", "float32") -> operations per second


TABLE = {
    "H100": Peaks(3.35e12, {"float64": 34e12, "float32": 67e12}),
}


def for_device(kind):
    """The peaks of the card named ``kind``, or None for one not listed."""
    for key, peaks in TABLE.items():
        if key in (kind or ""):
            return peaks
    return None
