"""Device (JAX) bit packing: (value, width) field streams → packed words.

Data-parallel replacement for the reference's sequential BitWriter
(reference: src/bit.rs:4-61).  A DEFLATE bit stream is a concatenation of
variable-width LSB-first fields; instead of feeding them through a serial
accumulator, compute every field's absolute bit offset with one exclusive
prefix sum, split each field's bits into (lo, hi) word contributions, and
scatter-add into the output words.  Fields never share bit positions, so
integer adds are exact ORs (no carries) and the whole pack is one
data-parallel pass.

Fields must be ≤ 28 bits wide (DEFLATE's worst field — 15-bit code +
13 extra bits — fits; a field then spans at most 2 words).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_FIELD_BITS = 28


@jax.jit
def pack_fields(values: jnp.ndarray, widths: jnp.ndarray
                ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Pack fields into 32-bit little-endian words.

    Args:
        values: (M,) int32/uint32 — LSB-first payloads (only low ``width``
            bits are used; callers must pre-mask).
        widths: (M,) int32 — field widths in bits, 0 to skip a field.

    Returns:
        (words, total_bits): words is (ceil(M*28/32)+1,) uint32 — sized
        for the worst case; total_bits (scalar int32) tells how many bits
        are meaningful.
    """
    values = values.astype(jnp.uint32)
    widths = widths.astype(jnp.int32)
    m = values.shape[0]
    n_words = (m * MAX_FIELD_BITS) // 32 + 2

    ends = jnp.cumsum(widths)
    offsets = ends - widths                       # exclusive prefix sum
    total_bits = ends[-1] if m else jnp.int32(0)

    word_idx = offsets >> 5
    shift = (offsets & 31).astype(jnp.uint32)

    masked = values & ((jnp.uint32(1) << widths.astype(jnp.uint32)) - 1)
    lo = masked << shift
    # v >> (32 - s) is undefined for s == 0; double-shift avoids it
    hi = (masked >> (jnp.uint32(31) - shift)) >> jnp.uint32(1)

    # One scatter instead of two: field f-1's spill word (hi) is always
    # field f's word (hi[f-1] != 0 implies f-1 crossed its boundary, so
    # word_idx[f] == word_idx[f-1] + 1; when hi[f-1] == 0 the add is a
    # no-op) — fold it into f's contribution.  The last field's spill
    # has no successor and lands with a single dynamic add.
    hi_prev = jnp.concatenate([jnp.zeros((1,), jnp.uint32), hi[:-1]])
    words = jnp.zeros((n_words,), jnp.uint32)
    words = words.at[word_idx].add(lo + hi_prev, indices_are_sorted=True,
                                   mode="drop")
    if m:
        words = words.at[word_idx[-1] + 1].add(hi[-1], mode="drop")
    return words, total_bits


@jax.jit
def words_to_bytes(words: jnp.ndarray) -> jnp.ndarray:
    """(W,) uint32 → (4W,) uint8, little-endian (DEFLATE byte order)."""
    shifts = jnp.arange(4, dtype=jnp.uint32) * 8
    b = (words[:, None] >> shifts[None, :]) & 0xFF
    return b.reshape(-1).astype(jnp.uint8)


def pack_fields_batch(values: jnp.ndarray, widths: jnp.ndarray):
    """vmapped pack over a leading block axis: (B, M) → (B, W), (B,)."""
    return jax.vmap(pack_fields)(values, widths)
