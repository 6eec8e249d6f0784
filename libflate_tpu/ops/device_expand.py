"""Device-resident LZ77 expansion: tokens -> plaintext, plain XLA.

The reference expands with a sequential overlapping copy
(libflate_lz77/src/lib.rs:164-194).  Here every output position gets a
source pointer and the pointers are resolved in parallel:

1. **Covering token** — scatter each token's id at its output start,
   then a running max gives every position its token.
2. **Mod-collapse** — a byte inside an overlapped (RLE) copy points
   straight at the PRE-TOKEN source: src(p) = s - d + (p - s) mod d
   for a match of distance d starting at s.  Every pointer then
   crosses a token boundary backwards, so chain depth is the token
   DAG depth (tens to hundreds on text), not the run length.
3. **Pointer jumping** — ``src = src[src]`` until nothing changes:
   log2(chain depth) rounds of one gather each; literals are roots.

Members are independent (PGZF container) unless a ``history`` row
supplies earlier output (raw DEFLATE blocks, ops.deflate_decode).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _expand_row(a, b, nt, hist, hl, out_cap: int):
    t = a.shape[0]
    h = hist.shape[0]
    tidx = jnp.arange(t, dtype=jnp.int32)
    valid = tidx < nt
    is_match = valid & (b > 0)
    lens = jnp.where(valid, jnp.where(is_match, a, 1), 0)
    ends = jnp.cumsum(lens)
    starts = ends - lens
    n_out = ends[-1]
    # a match may reach back into the history but not before it
    err = (n_out > out_cap) | jnp.any(is_match & (b > starts + hl))

    marks = jnp.zeros((out_cap,), jnp.int32).at[
        jnp.where(valid & (lens > 0), starts, out_cap)].max(
        tidx, mode="drop")
    tok = jax.lax.cummax(marks)
    j = jnp.arange(out_cap, dtype=jnp.int32)
    s = starts[tok]
    d = jnp.maximum(b[tok], 1)
    copy = is_match[tok] & (j < n_out)
    src = jnp.where(copy, s - d + (j - s) % d, j) + h
    lit = jnp.where(copy | (j >= n_out), 0, a[tok]).astype(jnp.uint8)

    # combined coordinates: [0, h) history roots, [h, h + out_cap) new
    src = jnp.clip(jnp.concatenate([jnp.arange(h, dtype=jnp.int32), src]),
                   0, h + out_cap - 1)
    lit = jnp.concatenate([hist.astype(jnp.uint8), lit])
    return resolve_bytes(src, lit)[h:], jnp.minimum(n_out, out_cap), err


def resolve_bytes(src: jnp.ndarray, lit: jnp.ndarray) -> jnp.ndarray:
    """Pointer jumping: ``lit`` at the root of every position's chain.

    src: (n,) int32 source pointers, each either a root (src[p] == p)
    or pointing at an earlier position; lit: (n,) root values.  Every
    round halves the remaining chain length: ``src = src[src]`` until
    nothing changes.
    """
    def cond(state):
        return state[1]

    def body(state):
        p, _ = state
        p2 = p[p]
        return p2, jnp.any(p2 != p)

    p, _ = jax.lax.while_loop(cond, body, (src, jnp.bool_(True)))
    return lit[p]


@functools.partial(jax.jit, static_argnames=("out_cap",))
def expand_tokens(a: jnp.ndarray, b: jnp.ndarray, n_tokens: jnp.ndarray,
                  out_cap: int, history: jnp.ndarray | None = None,
                  hist_len: jnp.ndarray | None = None):
    """Parallel LZ77 expansion: (B, T) tokens -> (B, out_cap) bytes.

    Args:
        a, b: (B, T) int32 token fields (b == 0: literal byte a; else a
            match of length a at distance b).
        n_tokens: (B,) int32 valid token counts.
        out_cap: static output capacity per row.
        history: optional (B, H) uint8 earlier output, right-aligned
            (``history[:, H - hist_len:]`` is valid), that matches may
            reach into (parity: the reference's Lz77Decoder keeps the
            last 32 KiB — libflate_lz77/src/lib.rs:219-231).

    Returns:
        (out (B, out_cap) uint8, n_out (B,) int32, err (B,) bool); err
        flags a distance reaching before the available history and
        output overflow.  Bytes past n_out are zero.
    """
    bsz = a.shape[0]
    if history is None:
        history = jnp.zeros((bsz, 0), jnp.uint8)
        hist_len = jnp.zeros((bsz,), jnp.int32)
    return jax.vmap(lambda aa, bb, nt, hh, hl: _expand_row(
        aa, bb, nt, hh, hl, out_cap))(
        a.astype(jnp.int32), b.astype(jnp.int32), n_tokens, history,
        hist_len)


def expand_members(packed: jnp.ndarray, n_tokens: jnp.ndarray,
                   out_cap: int):
    """``expand_tokens`` on packed tokens ``a | (b << 9)`` (the sync
    decoder's and the native engine's packing)."""
    return expand_tokens(packed & 511, (packed >> 9) & 0xFFFF, n_tokens,
                         out_cap)
