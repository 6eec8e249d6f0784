"""libflate_tpu usage tour (parity: the reference's examples/flate.rs
CLI is `python -m libflate_tpu.cli`; this file shows the library API).

Run:  PYTHONPATH=.. python usage.py   (from examples/)
"""
import sys

sys.path.insert(0, "..")

import libflate_tpu as lf
from libflate_tpu.formats import pgzf
from libflate_tpu.chunked import ChunkedGzipDecoder
from libflate_tpu.serial.deflate import EncodeOptions

data = (b"The quick brown fox jumps over the lazy dog. " * 2000)

# --- one-shot container APIs ------------------------------------------------
gz = lf.gzip.compress(data)
assert lf.gzip.decompress(gz) == data

z = lf.zlib.compress(data, EncodeOptions(matcher="chain"))  # best ratio
assert lf.zlib.decompress(z) == data

raw = lf.deflate.compress(data)
assert lf.deflate.decompress(raw) == data
print(f"gzip {len(gz)}B  zlib {len(z)}B  raw {len(raw)}B "
      f"from {len(data)}B")

# --- gzip header options ----------------------------------------------------
hdr = (lf.gzip.HeaderBuilder()
       .mtime(0)
       .filename(b"tour.txt")
       .verify()                     # header CRC-16
       .finish())
gz2 = lf.gzip.compress(data, header=hdr)
dec = lf.gzip.Decoder(gz2)
print("header:", dec.header.filename, "verified:", dec.header.is_verified)

# --- PGZF: the parallel container -------------------------------------------
stream = pgzf.compress(data, member_size=16 * 1024)
assert pgzf.decompress(stream) == data
print(f"pgzf: {len(pgzf.index_members(stream))} members, "
      f"{len(stream)}B, still plain gzip")

# --- streaming / resumable decode -------------------------------------------
cd = ChunkedGzipDecoder()
out = bytearray()
for i in range(0, len(gz), 997):                 # adversarial chunking
    out += cd.feed(gz[i:i + 997])
cd.finish()
assert bytes(out) == data
print("chunked decode ok:", len(out), "bytes")

# --- foreign streams (any producer) -----------------------------------------
import gzip as stdgz

foreign = b"".join(stdgz.compress(data[i:i + 8192], 6)
                   for i in range(0, 32768, 8192))
assert pgzf.decompress(foreign) == data[:32768]
print("foreign multi-member stream decoded")
# The same stream lands DEVICE-resident (on the CPU the decode kernel
# runs interpreted):
#   plain, lens = pgzf.decompress_to_device(foreign)

# --- device encode quality knobs (the device engine) -----------------------
# default: sort matcher, exact 16-byte lengths extended to full matches
#   pgzf.compress(data, engine="tpu")
# deeper search: hash-chain depth 8
#   pgzf.compress(data, engine="tpu",
#                 options=EncodeOptions(matcher="chain", max_chain=8))
# faster, shorter matches: lengths capped at 16 bytes
#   pgzf.compress(data, engine="tpu", options=EncodeOptions(lcp_rounds=4))

# --- completion protocol ----------------------------------------------------
import io

with lf.AutoFinish(lf.gzip.Encoder(io.BytesIO())) as enc:
    enc.write(b"auto-finished")
print("done")
