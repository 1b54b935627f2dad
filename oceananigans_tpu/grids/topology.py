"""Topologies and staggered-grid locations.

Mirrors the reference's topology/location trait system
(reference: src/Grids/Grids.jl:47-109) but as lightweight enums that live in
*static* (hashable) grid dataclasses, so that XLA specializes every kernel on
topology — the JAX analogue of Julia type-parameter dispatch.

Locations: ``C`` (Center) and ``F`` (Face) per direction; a field's location is
a 3-tuple like ``("f", "c", "c")`` for the u-velocity on an Arakawa C grid.
"""

from __future__ import annotations

# -- Topologies ----------------------------------------------------------------

PERIODIC = "periodic"
BOUNDED = "bounded"
FLAT = "flat"
# Distributed-local topologies (reference: FullyConnected / LeftConnected /
# RightConnected, src/Grids/Grids.jl). In this rebuild we use global-view
# sharded arrays, so these only appear on per-shard *local* grids.
FULLY_CONNECTED = "fully_connected"

TOPOLOGIES = (PERIODIC, BOUNDED, FLAT, FULLY_CONNECTED)

# -- Locations -----------------------------------------------------------------

CENTER = "c"
FACE = "f"

# Canonical C-grid staggering
LOC_CCC = (CENTER, CENTER, CENTER)  # tracers, pressure
LOC_FCC = (FACE, CENTER, CENTER)    # u
LOC_CFC = (CENTER, FACE, CENTER)    # v
LOC_CCF = (CENTER, CENTER, FACE)    # w
LOC_FFC = (FACE, FACE, CENTER)      # vertical vorticity


def validate_topology(topo):
    topo = tuple(topo)
    if len(topo) != 3:
        raise ValueError(f"topology must have 3 entries, got {topo}")
    for t in topo:
        if t not in TOPOLOGIES:
            raise ValueError(f"unknown topology {t!r}; expected one of {TOPOLOGIES}")
    return topo


def validate_location(loc):
    loc = tuple(loc)
    if len(loc) != 3:
        raise ValueError(f"location must have 3 entries, got {loc}")
    for l in loc:
        if l not in (CENTER, FACE, None):
            raise ValueError(f"unknown location {l!r}")
    return loc
