"""Sort-based LZ77 candidate finder — content-ordered back-scan.

Sort every position by its big-endian 4-byte prefix word, ties by
position (``lax.sort`` with two keys); a position's best candidates are
then its IMMEDIATELY PRECEDING sorted neighbors: among equal prefixes
they are exactly the zlib hash chain (nearest previous occurrence
first), across a prefix boundary they are the longest-shared-prefix
predecessors, and the shared-prefix length falls out of key XORs.  The
next prefix words (w4[p+4], w4[p+8], ...) are gathered in sorted order,
so the back-scan scores candidates by their EXACT shared length up to
``m_exact`` bytes.  A scatter by position restores text order.

This is the device encoder's one matcher on every backend.

Parity note: replaces the reference's single-slot prefix table
(libflate_lz77/src/default.rs:69-129); candidate quality is a superset
(its table keeps one entry per 3-byte hash, this keeps every
occurrence in prefix order, scored by shared length).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

#: sorted neighbors examined per position (the effective chain depth)
SCAN_K = 8
#: exact shared-length bound from the carried prefix words.  The
#: encoder's default lengths are these exact values (matches cap at 16
#: bytes, dist-1 runs aside); EncodeOptions.lcp_rounds extends them.
M_EXACT = 16


def _w4be(dd: jnp.ndarray, o: int, n: int) -> jnp.ndarray:
    return ((dd[:, o:o + n] << 24) | (dd[:, o + 1:o + n + 1] << 16)
            | (dd[:, o + 2:o + n + 2] << 8) | dd[:, o + 3:o + n + 3])


def _lead_bytes(x: jnp.ndarray) -> jnp.ndarray:
    """Equal leading bytes of two big-endian words, given their XOR."""
    return jnp.where(
        x == 0, 4,
        jnp.where(x >= 0x1000000, 0,
                  jnp.where(x >= 0x10000, 1, jnp.where(x >= 0x100, 2, 3))))


def _shift(x: jnp.ndarray, k: int, fill) -> jnp.ndarray:
    """x[:, i - k] along axis 1, ``fill`` for i < k."""
    pad = jnp.full((x.shape[0], k), fill, x.dtype)
    return jnp.concatenate([pad, x[:, :-k]], axis=1)


@functools.partial(jax.jit,
                   static_argnames=("window", "scan_k", "m_exact"))
def sort_candidates(blocks: jnp.ndarray, window: int = 32768,
                    scan_k: int = SCAN_K, m_exact: int = M_EXACT):
    """(B, n) uint8 member bytes -> (cand, m) both (B, n) int32.

    cand[p]: best earlier position within ``window`` scored by
    (exact shared-prefix length up to ``m_exact``) major, nearness
    minor; -1 if none shares >= 3 bytes.
    m[p]: the EXACT shared-prefix length with cand, clipped to
    ``m_exact`` (0 where cand is -1).  Bytes past the row end count as
    zeros, so claims in the last ``m_exact`` bytes can exceed the true
    length; callers clip lengths to the valid region.
    """
    if m_exact % 4 or not 4 <= m_exact <= 24:
        raise ValueError(f"m_exact must be a multiple of 4 in [4, 24], "
                         f"got {m_exact}")
    bsz, n = blocks.shape
    d = blocks.astype(jnp.uint32)
    dd = jnp.concatenate([d, jnp.zeros((bsz, m_exact + 7), jnp.uint32)],
                         axis=1)
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :],
                           (bsz, n))
    key, spos = jax.lax.sort((_w4be(dd, 0, n), pos), dimension=1,
                             num_keys=2)
    words = [jnp.take_along_axis(_w4be(dd, o, n), spos, axis=1)
             for o in range(4, m_exact, 4)]

    best_score = jnp.full((bsz, n), -1, jnp.int32)
    best_cand = jnp.full((bsz, n), -1, jnp.int32)
    best_l = jnp.zeros((bsz, n), jnp.int32)
    for k in range(1, scan_k + 1):
        x = key ^ _shift(key, k, 0)
        lcp = _lead_bytes(x)
        all_eq = x == 0
        for i, w in enumerate(words, start=1):
            xi = w ^ _shift(w, k, 0)
            lcp = jnp.where(all_eq, 4 * i + _lead_bytes(xi), lcp)
            all_eq = all_eq & (xi == 0)
        # the fill makes dist negative at the row head: rejected
        pp = _shift(spos, k, n)
        dist = spos - pp
        ok = (dist > 0) & (dist <= window) & (lcp >= 3)
        score = (lcp << 17) + (window - dist)
        upd = ok & (score > best_score)
        best_score = jnp.where(upd, score, best_score)
        best_cand = jnp.where(upd, pp, best_cand)
        best_l = jnp.where(upd, lcp, best_l)

    rows = jnp.arange(bsz, dtype=jnp.int32)[:, None]
    cand = jnp.zeros((bsz, n), jnp.int32).at[rows, spos].set(
        best_cand, unique_indices=True)
    m = jnp.zeros((bsz, n), jnp.int32).at[rows, spos].set(
        jnp.minimum(best_l, m_exact), unique_indices=True)
    return cand, m
