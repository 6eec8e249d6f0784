"""Device mesh helpers for block/member-parallel codec scale-out.

The reference is single-threaded (SURVEY.md §2.3); the framework's
distribution model is:

* a 1-D ``blocks`` mesh axis — DEFLATE blocks / gzip members are
  embarrassingly parallel (per-block LZ77 reset, SURVEY.md §2.3.1);
* checksum folding via exact CRC/Adler combine operators (log-depth
  reductions instead of serial update);
* ordered gather of variable-length member outputs on the host edge.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_mesh(n_devices: int | None = None,
              devices=None) -> Mesh:
    """1-D mesh over ``n_devices`` (default: all available)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (BLOCK_AXIS,))


def block_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading block axis across the mesh."""
    return NamedSharding(mesh, P(BLOCK_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
