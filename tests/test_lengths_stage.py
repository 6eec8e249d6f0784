"""Match-length stage of the device tokenizer (ops/pipeline)."""




def test_chain_candidates_improve_or_match():
    """chain>1 round-trips and never produces worse lengths than the
    single-slot candidates (best-of includes depth 1)."""
    import numpy as np
    import jax.numpy as jnp
    from libflate_tpu.ops import pipeline as pp
    from libflate_tpu.ops.sort_match import sort_candidates
    from libflate_tpu.serial.lz77 import expand_tokens

    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(3, 9),
                                dtype=np.uint8)) for _ in range(50)]
    rows = []
    for i in range(8):
        row = b"\n".join(words[int(j)] for j in
                         rng.zipf(1.3, 700) % 50)[:2048]
        rows.append(row.ljust(2048, b"x"))
    blocks = jnp.asarray(np.frombuffer(b"".join(rows),
                                       np.uint8).reshape(8, 2048))
    nv = jnp.full((8,), 2048, jnp.int32)
    cand, m = sort_candidates(blocks, window=2048)
    _, l1 = pp._lengths_stage(blocks, nv, cand, m, False, 2048, 1, 8)
    c3, l3 = pp._lengths_stage(blocks, nv, cand, m, False, 2048, 3, 8)
    l1, l3 = np.asarray(l1), np.asarray(l3)
    assert (l3 >= l1).all()
    assert l3.sum() > l1.sum()          # chains find deeper matches
    # chosen candidates decode correctly: greedy-expand a member using
    # (cand, len) pairs and compare against the plaintext
    c3 = np.asarray(c3)
    data = np.asarray(blocks)
    for b in range(0, 8, 3):
        p, toks = 0, []
        while p < 2048:
            ln = int(l3[b, p])
            if ln >= 3:
                toks.append((ln, p - int(c3[b, p])))
                p += ln
            else:
                toks.append((int(data[b, p]), 0))
                p += 1
        out = expand_tokens(toks)
        assert bytes(out) == data[b].tobytes()


def test_lcp_rounds_knob_caps_lengths():
    """EncodeOptions.lcp_rounds semantics on the sort-matcher path:
    rounds = 4 = m_exact // 4 uses the exact-16 sort lengths as they
    are, capping non-RLE match lengths at 16; more rounds, or the
    default (None), only ever lengthen matches."""
    import numpy as np
    import jax.numpy as jnp
    from libflate_tpu.ops import pipeline as pp
    from libflate_tpu.ops.sort_match import M_EXACT, sort_candidates

    rng = np.random.default_rng(9)
    # long repeats far apart so matches extend well past 16 bytes
    motif = bytes(rng.integers(97, 123, 40, dtype=np.uint8))
    row = (motif + bytes(rng.integers(97, 123, 120, dtype=np.uint8))
           ) * 4
    blocks = jnp.asarray(np.frombuffer(
        (row * 2)[:1024].ljust(1024, b"q"), np.uint8)[None, :])
    nv = jnp.full((1,), 1024, jnp.int32)
    cand, m4 = sort_candidates(blocks, window=512)

    _, l_skip = pp._lengths_stage(blocks, nv, cand, m4, False, 1024, 1,
                                  M_EXACT // 4)
    _, l_ext = pp._lengths_stage(blocks, nv, cand, m4, False, 1024, 1, 8)
    _, l_def = pp._lengths_stage(blocks, nv, cand, m4, False, 1024, 1,
                                 None)
    l_skip, l_ext = np.asarray(l_skip), np.asarray(l_ext)
    assert (np.asarray(l_def) >= l_ext).all()
    cand_np = np.asarray(cand)
    idx = np.arange(1024)
    non_rle = cand_np[0] != idx - 1
    # default: non-RLE lengths cap at the exact sort bound
    assert l_skip[0][non_rle].max(initial=0) <= M_EXACT
    # extension only lengthens, and finds > 16 on this corpus
    assert (l_ext >= l_skip).all()
    assert l_ext[0][non_rle].max(initial=0) > M_EXACT
