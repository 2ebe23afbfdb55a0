"""Per-device runtime constants, keyed by ``device_kind``.

``Renderer`` reads ``lanes_target``/``m_max`` to pick the wavefront's
pixels per lane (M) for a frame, and ``parallel/sharding.py`` does the same
per band.  The image is bit-identical for every M; M only moves speed: more
lanes fill more of the device, fewer lanes average more pixels per lane
(shorter straggler tails).

Every row is a measurement on that device (PERF.md).  A device kind not in
the table is an error, not a default: a new device gets its row from a
measurement first.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ChipProfile:
    kind_substr: str  # matched against jax.devices()[0].device_kind
    lanes_target: int  # wavefront lanes to aim for (M heuristic)
    m_max: int  # pixels-per-lane cap


PROFILES = (
    # grid kernel, book scene 1920x1080, 320 spp: M = 2..6 within 2% of
    # each other, M = 16 13% slower (PERF.md); 2^19 lanes gives M = 3
    ChipProfile("H100", 1 << 19, 64),
    ChipProfile("cpu", 1 << 15, 64),  # tests and CPU debugging
)


def profile_for(device_kind: Optional[str] = None) -> ChipProfile:
    """Profile for the live (or given) device kind; raises for a kind the
    table does not know."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    kind = device_kind.lower()
    for p in PROFILES:
        if p.kind_substr.lower() in kind:
            return p
    raise ValueError(f"no runtime profile for device kind {device_kind!r} "
                     "(runtime/chips.py)")
