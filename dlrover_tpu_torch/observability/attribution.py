"""Device-time attribution buckets.

The pure part of ``dlrover_tpu/observability/attribution.py`` that the
health engine reads: the five stable bucket names (``CATEGORIES`` :53)
and ``dominant_category`` (:106).  The trace parser and the worker that
fills these shares are ROADMAP A7; until then no ``step_profile`` span
reaches the port's master and every node's share stays empty.
"""

from typing import Dict, Optional

CATEGORIES = ("compute", "collective", "copy", "infeed", "idle")


def dominant_category(shares: Dict[str, float]) -> Optional[tuple]:
    """``(name, share)`` of the biggest bucket, None when empty."""
    busy = [(c, shares.get(c, 0.0)) for c in CATEGORIES]
    busy = [t for t in busy if t[1] > 0]
    if not busy:
        return None
    return max(busy, key=lambda t: t[1])
