"""Device (JAX) LZ77 match lengths and greedy parse — branchless.

Data-parallel redesign of the reference's sequential hash-table scan
(reference: libflate_lz77/src/default.rs:60-129).  Candidates come from
ops/sort_match; this module turns them into tokens:

1. **Match lengths** — vectorized LCP: compare 4-byte words, find the
   first differing byte from the XOR, iterate only while any lane is
   still extending (`lax.while_loop`) over a compacted survivor set.
   Exact after clipping to the block end.
2. **Greedy parse** — the "skip by match length" recurrence is the only
   left-to-right dependency.  It is solved hierarchically: positions are
   grouped into chunks of ``PARSE_CHUNK`` ≥ 258 (a jump can never skip a
   whole chunk); pointer-doubling computes every position's *chunk-exit*
   in log₂(chunk) rounds; a short scan threads entries between chunks;
   a final vectorized walk (all chunks in lockstep) marks token starts.

The result are fixed-shape token arrays (a, b) + token count per block —
directly consumable by ops.deflate_encode.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..spec import constants as C

PARSE_CHUNK = 512          # ≥ MAX_MATCH so a jump crosses ≤ 1 boundary


# ---------------------------------------------------------------------------
# Match lengths
# ---------------------------------------------------------------------------
def _words4(data: jnp.ndarray) -> jnp.ndarray:
    """Unaligned 4-byte little-endian word starting at each position."""
    n = data.shape[0]
    d = data.astype(jnp.uint32)
    pad = jnp.zeros((3,), jnp.uint32)
    dd = jnp.concatenate([d, pad])
    return (dd[:n] | (dd[1:n + 1] << 8) | (dd[2:n + 2] << 16)
            | (dd[3:n + 3] << 24))


def match_lengths(data: jnp.ndarray, cand: jnp.ndarray,
                  max_match: int = C.MAX_MATCH,
                  max_rounds: int | None = None,
                  known: jnp.ndarray | None = None,
                  known_cap: int = 0) -> jnp.ndarray:
    """Exact LCP between each position and its candidate, clipped to the
    block end and ``max_match``.  0 where cand < 0.

    ``max_rounds`` bounds the 4-byte extension rounds (matches cap at
    ~4*max_rounds bytes): one straggler position extending to 258
    otherwise drags every lane through 65 gather rounds.  Truncated
    lengths are still valid DEFLATE matches — pure ratio/time trade.

    ``known``: exact shared lengths already known up to ``known_cap``
    bytes (a multiple of 4; the sort matcher's), so only positions with
    ``known == known_cap`` extend, from there."""
    n = data.shape[0]
    w4 = _words4(data)
    idx = jnp.arange(n, dtype=jnp.int32)
    limit = jnp.minimum(max_match, n - idx)

    def extend(ln, active, pos, cnd, lim):
        ca = jnp.clip(cnd + ln, 0, n - 1)
        cb = jnp.clip(pos + ln, 0, n - 1)
        x = w4[ca] ^ w4[cb]
        full = (x == 0)
        tz = jnp.where(full, 4,
                       jnp.where(x & 0xFF, 0,
                                 jnp.where(x & 0xFFFF, 1,
                                           jnp.where(x & 0xFFFFFF, 2, 3))))
        ln = jnp.minimum(ln + jnp.where(active, tz, 0), lim)
        return ln, active & full & (ln < lim)

    if known is None:
        # dense phase: 3 rounds (12 bytes) cover the overwhelming
        # majority of matches; each round is 2 full-array gathers
        done = 3
        ln = jnp.zeros((n,), jnp.int32)
        active = cand >= 0
        for _ in range(done):
            ln, active = extend(ln, active, idx, cand, limit)
    else:
        done = known_cap // 4
        ln = jnp.where(cand >= 0, jnp.minimum(known, limit), 0)
        active = (cand >= 0) & (known >= known_cap) & (ln < limit)
    budget = 64 if max_rounds is None else max_rounds - done

    # sparse phase: survivors (long matches, typically a few % of
    # positions) are compacted so the remaining rounds gather only
    # survivor-sized arrays instead of the full block every round
    cap = max(256, n // 8)
    rank = jnp.cumsum(active.astype(jnp.int32)) - 1
    n_sur = jnp.sum(active.astype(jnp.int32))
    slot = jnp.where(active & (rank < cap), rank, cap)
    s_pos = jnp.zeros((cap + 1,), jnp.int32).at[slot].max(
        jnp.where(active, idx, 0), mode="drop")[:cap]
    valid = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(n_sur, cap)
    s_pos_c = jnp.clip(s_pos, 0, n - 1)
    s_cand = cand[s_pos_c]
    s_lim = limit[s_pos_c]
    s_ln = ln[s_pos_c]

    def cond(state):
        _, act, rounds = state
        return jnp.any(act) & (rounds < budget)

    def body(state):
        sl, act, rounds = state
        sl, act = extend(sl, act, s_pos, s_cand, s_lim)
        return sl, act, rounds + 1

    s_ln, _, _ = jax.lax.while_loop(cond, body,
                                    (s_ln, valid, jnp.int32(0)))
    ln = ln.at[s_pos_c].max(jnp.where(valid, s_ln, 0), mode="drop")

    # exactness fallback: survivors past `cap` (pathological high-
    # redundancy blocks) finish with the dense loop — empty in normal
    # data, so the while exits after one predicate evaluation
    overflow = active & (rank >= cap)

    def body2(state):
        l2, act, rounds = state
        l2, act = extend(l2, act, idx, cand, limit)
        return l2, act, rounds + 1

    ln, _, _ = jax.lax.while_loop(cond, body2,
                                  (ln, overflow, jnp.int32(0)))
    return jnp.where(cand >= 0, jnp.minimum(ln, limit), 0)


# ---------------------------------------------------------------------------
# Greedy parse
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("min_match",))
def greedy_parse_marks(lengths: jnp.ndarray, min_match: int = C.MIN_MATCH
                       ) -> jnp.ndarray:
    """(n,) match lengths → (n,) bool: does a token start at position p?

    Implements: p=0; while p<n: emit token at p; p += max(1, len[p] if
    len[p] >= min_match).  Parallelized via chunk-exit pointer doubling +
    lockstep chunk walk.
    """
    n = lengths.shape[0]
    s = PARSE_CHUNK
    n_chunks = -(-n // s)
    n_pad = n_chunks * s
    idx = jnp.arange(n_pad, dtype=jnp.int32)
    ln = jnp.pad(lengths, (0, n_pad - n))
    jump = idx + jnp.where(ln >= min_match, jnp.maximum(ln, 1), 1)
    jump = jnp.minimum(jump, n_pad)                  # clamp into sentinel

    chunk_of = idx // s
    # chunk-exit map: g[p] = first position outside p's chunk on the
    # orbit.  Pointer doubling with early exit: resolution completes in
    # ceil(log2(longest in-chunk orbit)) rounds (~7 typical), not the
    # static worst case.
    max_rounds = max(1, s.bit_length())

    def d_cond(state):
        g, r = state
        inside = (g < n_pad) & ((g // s) == chunk_of)
        return jnp.any(inside) & (r < max_rounds)

    def d_body(state):
        g, r = state
        inside = (g < n_pad) & ((g // s) == chunk_of)
        return jnp.where(inside, g[jnp.clip(g, 0, n_pad - 1)], g), r + 1

    g, _ = jax.lax.while_loop(d_cond, d_body, (jump, jnp.int32(0)))

    # thread entries: entry of chunk 0 is 0; scan applies g per chunk
    def chunk_step(pos, t):
        in_chunk = (pos // s) == t
        new_pos = jnp.where(in_chunk, g[jnp.clip(pos, 0, n_pad - 1)], pos)
        return new_pos, pos
    _, entries = jax.lax.scan(chunk_step, jnp.int32(0),
                              jnp.arange(n_chunks, dtype=jnp.int32))
    # entries[t] = orbit position at the start of chunk t's processing

    # lockstep local walk with early exit: typical tokens per chunk are
    # ~s/6, so sweeping all s steps wastes ~6x — walk in slices of 64
    # under a while_loop that stops once every chunk's cursor has left
    # (all-literal chunks still take the full s steps, correctly)
    jump2d = jump.reshape(n_chunks, s)
    t_axis = jnp.arange(n_chunks, dtype=jnp.int32)
    WALK_SLICE = 64
    n_slices = s // WALK_SLICE

    def walk_step(pos, _):
        active = (pos // s) == t_axis
        local = jnp.clip(pos - t_axis * s, 0, s - 1)
        nxt = jnp.where(active, jump2d[t_axis, local], pos)
        return nxt, (active, local)

    def cond(state):
        pos, _starts, si = state
        return (si < n_slices) & jnp.any((pos // s) == t_axis)

    def body(state):
        pos, starts, si = state
        pos, (marks_steps, locals_steps) = jax.lax.scan(
            walk_step, pos, None, length=WALK_SLICE)
        flat_mark = marks_steps.reshape(-1)
        flat_pos = (locals_steps + (t_axis[None, :] * s)).reshape(-1)
        starts = starts.at[flat_pos].max(flat_mark)
        return pos, starts, si + 1

    starts0 = jnp.zeros((n_pad,), jnp.bool_)
    _, starts, _ = jax.lax.while_loop(
        cond, body, (entries, starts0, jnp.int32(0)))
    return starts[:n]


def parse_tokens(data: jnp.ndarray, n_valid: jnp.ndarray,
                 cand: jnp.ndarray, lengths: jnp.ndarray,
                 max_tokens: int):
    """Greedy parse + compaction: (n,) candidates and match lengths
    (0 where no match) -> (a, b, n_tokens) token arrays."""
    n = data.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    starts = greedy_parse_marks(lengths)
    starts = starts & (idx < n_valid)

    token_rank = jnp.cumsum(starts.astype(jnp.int32)) - 1
    n_tokens = jnp.sum(starts.astype(jnp.int32))
    is_match = starts & (lengths >= C.MIN_MATCH)
    a_src = jnp.where(is_match, lengths, data.astype(jnp.int32))
    b_src = jnp.where(is_match, idx - cand, 0)

    # compaction by scatter-ADD: non-start positions contribute zero to
    # whatever slot their running rank points at — harmless, no clobber
    a = jnp.zeros((max_tokens,), jnp.int32).at[
        jnp.clip(token_rank, 0, max_tokens - 1)].add(
        jnp.where(starts, a_src, 0))
    b = jnp.zeros((max_tokens,), jnp.int32).at[
        jnp.clip(token_rank, 0, max_tokens - 1)].add(
        jnp.where(starts, b_src, 0))
    return a, b, n_tokens
