"""Device (JAX) Huffman machinery: package-merge, canonical codes, tables.

Data-parallel redesign of the reference's heap/Vec algorithms (reference:
src/huffman.rs):

* :func:`package_merge_lengths` — optimal length-limited code lengths as
  pure array ops.  Exploits the monotonicity of package-merge on sorted
  frequencies: instead of tracking symbol *sets* per package (reference:
  huffman.rs:307-362 merges Vec<symbol> lists), run one upward
  construction pass storing per-level sorted item weights + leaf flags,
  then one downward *selection-counting* pass.  At each level only the
  **count** of selected leaves matters: the k-th smallest active symbol
  gets code length  Σ_d [k < c_d].  O(L·N log N) in sorts, no heap, no
  ragged data — vmappable over blocks.
* :func:`canonical_codes_jax` — code assignment via bl_count cumsum +
  per-length exclusive rank (one-hot cumsum), ≙ huffman.rs:35-55.
* :func:`decode_table` — flat 2^bits table built *gather-free per index*:
  for every table index, try each code length (15 candidates) against the
  canonical (first, count) ranges — a branchless select chain — then one
  gather for the symbol.  ≙ huffman.rs:96-122's scatter loop, inverted.

Table entry layout: ``(symbol << 4) | width``; width 0 marks invalid.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..spec.constants import MAX_BITWIDTH

_INF = jnp.int32(1 << 30)


# ---------------------------------------------------------------------------
# Package-merge (length-limited Huffman) — single block; vmap over blocks
# ---------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("limit",))
def package_merge_lengths(freqs: jnp.ndarray,
                          limit: int = MAX_BITWIDTH) -> jnp.ndarray:
    """Optimal code lengths ≤ ``limit`` for int32 ``freqs`` (N,).

    Unused symbols (freq 0) get length 0.  Assumes the number of active
    symbols fits the limit (always true for DEFLATE alphabets).
    """
    n = freqs.shape[0]
    s = 2 * n                                   # fixed item-array width
    freqs = freqs.astype(jnp.int32)
    active = freqs > 0
    n_active = jnp.sum(active.astype(jnp.int32))

    leaf_w = jnp.sort(jnp.where(active, freqs, _INF))          # (N,) asc
    leaf_items = jnp.concatenate([leaf_w, jnp.full((n,), _INF, jnp.int32)])

    def merge_with_leaves(pkg: jnp.ndarray):
        """Stable merge of leaves (first) and packages by weight."""
        w = jnp.concatenate([leaf_w, pkg])                     # (N + S,)
        is_leaf = jnp.concatenate([jnp.ones((n,), jnp.int32),
                                   jnp.zeros((s,), jnp.int32)])
        order = jnp.argsort(w, stable=True)                    # leaves win ties
        return w[order][:s], is_leaf[order][:s]

    def pair_sums(items: jnp.ndarray) -> jnp.ndarray:
        a, b = items[0::2], items[1::2]
        ps = jnp.where((a >= _INF) | (b >= _INF), _INF,
                       jnp.minimum(a + b, _INF))
        return jnp.concatenate([ps, jnp.full((s - ps.shape[0],), _INF,
                                             jnp.int32)])

    # upward construction: deepest level = leaves only
    items = leaf_items                                         # level `limit`
    level_stack = [jnp.concatenate([jnp.ones((n,), jnp.int32),
                                    jnp.zeros((n,), jnp.int32)])]
    for _ in range(limit - 1):
        pkg = pair_sums(items)
        items, is_leaf = merge_with_leaves(pkg)
        level_stack.append(is_leaf)
    # level_stack[0] = deepest (level L) ... level_stack[-1] = top (level 1)

    # downward selection counting
    idx = jnp.arange(s, dtype=jnp.int32)
    m = 2 * jnp.maximum(n_active - 1, 0)
    cs = []
    for is_leaf in reversed(level_stack):
        c = jnp.sum(jnp.where(idx < m, is_leaf, 0))
        cs.append(c)
        m = 2 * (m - c)
    c_stack = jnp.stack(cs)                                    # (limit,)

    # k-th smallest active symbol gets length sum_d [k < c_d]
    rank_len = jnp.sum(
        (jnp.arange(n, dtype=jnp.int32)[None, :] < c_stack[:, None])
        .astype(jnp.int32), axis=0)                            # (N,) by rank

    # scatter back: rank of each active symbol in freq-sorted order
    order = jnp.argsort(jnp.where(active, freqs, _INF), stable=True)
    lengths = jnp.zeros((n,), jnp.int32).at[order].set(rank_len)
    lengths = jnp.where(active, lengths, 0)
    # single-active-symbol special case: give it length 1
    lengths = jnp.where((n_active == 1) & active, 1, lengths)
    return lengths


# ---------------------------------------------------------------------------
# Canonical code assignment
# ---------------------------------------------------------------------------
@jax.jit
def canonical_codes_jax(lengths: jnp.ndarray) -> jnp.ndarray:
    """Canonical (MSB-first) codes from lengths (N,) int32."""
    n = lengths.shape[0]
    lmax = MAX_BITWIDTH
    one_hot = (lengths[:, None] ==
               jnp.arange(1, lmax + 1)[None, :]).astype(jnp.int32)  # (N, 15)
    bl_count = jnp.sum(one_hot, axis=0)                             # (15,)
    # first[l] = (first[l-1] + bl_count[l-1]) << 1, first[0] = 0
    def step(carry, cnt):
        new = (carry + cnt) << 1
        return new, new
    _, firsts = jax.lax.scan(step, jnp.int32(0),
                             jnp.concatenate([jnp.zeros(1, jnp.int32),
                                              bl_count[:-1]]))
    # firsts[l-1] = first code of length l
    rank = jnp.cumsum(one_hot, axis=0) - one_hot                    # exclusive
    per_len_rank = jnp.sum(rank * one_hot, axis=1)
    first_of_len = jnp.sum(firsts[None, :] * one_hot, axis=1)
    return jnp.where(lengths > 0, first_of_len + per_len_rank, 0)


@jax.jit
def reverse_codes_jax(codes: jnp.ndarray, lengths: jnp.ndarray) -> jnp.ndarray:
    """Bit-reverse each code within its own width (encode-side layout)."""
    rev = jnp.zeros_like(codes)
    c = codes
    for _ in range(MAX_BITWIDTH):
        rev = (rev << 1) | (c & 1)
        c = c >> 1
    # rev now holds the 15-bit reversal; shift down to actual width
    return jnp.where(lengths > 0, rev >> (MAX_BITWIDTH - lengths), 0)


# ---------------------------------------------------------------------------
# Flat decode table
# ---------------------------------------------------------------------------
def _bit_reverse(v: jnp.ndarray, bits: int) -> jnp.ndarray:
    r = jnp.zeros_like(v)
    x = v
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x = x >> 1
    return r


@functools.partial(jax.jit, static_argnames=("table_bits",))
def decode_table(lengths: jnp.ndarray, table_bits: int = MAX_BITWIDTH
                 ) -> jnp.ndarray:
    """Build the flat decode table: (2^table_bits,) int32 = (sym<<4)|width.

    For every table index t (whose low bits are the LSB-first stream
    bits): reverse to MSB-first, then for each candidate width l check
    membership in the canonical range [first_l, first_l + count_l).
    Entries matching no code are 0 (width 0 ⇒ invalid).
    """
    n = lengths.shape[0]
    codes = canonical_codes_jax(lengths)
    one_hot = (lengths[:, None] ==
               jnp.arange(1, table_bits + 1)[None, :]).astype(jnp.int32)
    counts = jnp.sum(one_hot, axis=0)                          # (L,)
    offsets = jnp.cumsum(counts) - counts                      # (L,) exclusive
    # firsts per length
    def step(carry, cnt):
        new = (carry + cnt) << 1
        return new, new
    _, firsts = jax.lax.scan(step, jnp.int32(0),
                             jnp.concatenate([jnp.zeros(1, jnp.int32),
                                              counts[:-1]]))
    # symbols sorted by (length, symbol); length-0 last
    sort_key = jnp.where(lengths > 0, lengths, 99) * jnp.int32(n) + \
        jnp.arange(n, dtype=jnp.int32)
    sym_by_rank = jnp.argsort(sort_key).astype(jnp.int32)      # (N,)

    t = jnp.arange(1 << table_bits, dtype=jnp.int32)
    rev = _bit_reverse(t, table_bits)                          # MSB-first view
    best_width = jnp.zeros_like(t)
    best_rank = jnp.zeros_like(t)
    for l in range(1, table_bits + 1):
        cand = rev >> (table_bits - l)
        rel = cand - firsts[l - 1]
        ok = (rel >= 0) & (rel < counts[l - 1]) & (best_width == 0)
        best_width = jnp.where(ok, l, best_width)
        best_rank = jnp.where(ok, offsets[l - 1] + rel, best_rank)
    sym = sym_by_rank[jnp.clip(best_rank, 0, n - 1)]
    return jnp.where(best_width > 0, (sym << 4) | best_width, 0)
