"""Foreign-stream device decode (pgzf._foreign_to_device).

Streams from OTHER producers — stdlib gzip here — carry per-member
dynamic/fixed/stored blocks and no LF/LS index, so the shared-table
sync decoder cannot apply.  The bridge runs the sequential entropy
phase in the C engine (token decode, no byte materialization) and the
LZ77 expansion + CRC in the same device chain as the sync path.
Reference capability: src/deflate/decode.rs:136-164 (arbitrary
conformant streams through one decode loop).
"""
import gzip
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from libflate_tpu import native
from libflate_tpu.formats import pgzf

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="needs the native engine")


def test_stdlib_multi_member():
    rng = np.random.default_rng(0)
    base = b"the quick brown fox jumps over the lazy dog " * 300
    chunks = []
    for i in range(5):
        blob = bytes(rng.permutation(
            np.frombuffer(base, np.uint8)).tobytes()[:6000 + 900 * i])
        chunks.append(blob + base[:4000])
    stream = b"".join(gzip.compress(c, compresslevel=6) for c in chunks)
    out, lens = pgzf.decompress_to_device(stream, verify=True)
    out, lens = np.asarray(out), np.asarray(lens)
    for i, c in enumerate(chunks):
        assert lens[i] == len(c)
        assert bytes(out[i, :lens[i]].tobytes()) == c


def test_single_member_and_stored():
    base = b"abcabcabc" * 3000
    out, lens = pgzf.decompress_to_device(gzip.compress(base, 9))
    assert bytes(np.asarray(out)[0, :int(np.asarray(lens)[0])]
                 .tobytes()) == base
    blob = os.urandom(4096)           # incompressible -> stored blocks
    out, lens = pgzf.decompress_to_device(gzip.compress(blob, 0))
    assert bytes(np.asarray(out)[0, :int(np.asarray(lens)[0])]
                 .tobytes()) == blob


def test_corruption_detected():
    base = b"the quick brown fox " * 1000
    bad = bytearray(gzip.compress(base))
    bad[-5] ^= 0xFF                   # trailer CRC byte
    with pytest.raises(Exception):
        pgzf.decompress_to_device(bytes(bad), verify=True)


def test_native_token_decode_matches_zlib():
    base = b"banana banana banana " * 2000
    body = gzip.compress(base, 6)[10:]       # no FEXTRA at level calls
    toks, osize, eb = native.inflate_tokens(body, 0, 1 << 16)
    assert osize == len(base)
    # expand on the host oracle and compare
    out = bytearray()
    for t in toks:
        a, d = int(t) & 511, (int(t) >> 9) & 0xFFFF
        if d == 0:
            out.append(a)
        else:
            for _ in range(a):
                out.append(out[-d])
    assert bytes(out) == base
