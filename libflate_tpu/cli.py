"""Command-line tool (parity: reference examples/flate.rs).

Subcommands: copy, byte-read, gzip-decode, gzip-decode-multi,
gzip-encode, zlib-decode, zlib-encode — plus the device-engine extras
pgzf-encode / pgzf-decode.  "-" means stdin/stdout; /dev/null works as
an output sink.

``--stream`` runs the gzip/zlib codecs in bounded memory: input is
pulled CHUNK bytes at a time through the resumable chunked decoders /
the BlockStreamer encoder and copied straight to the output file
(parity: the reference CLI io::copy's through streaming codecs,
examples/flate.rs:68-112).  The default mode reads whole files and
uses the fastest available engine.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

_CHUNK = 1 << 20


def _read_input(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write_output(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            f.write(data)


@contextlib.contextmanager
def _open_in(path: str):
    if path == "-":
        yield sys.stdin.buffer
    else:
        with open(path, "rb") as f:
            yield f


@contextlib.contextmanager
def _open_out(path: str):
    if path == "-":
        yield sys.stdout.buffer
        sys.stdout.buffer.flush()
    else:
        with open(path, "wb") as f:
            yield f


def _pump(reader, writer) -> None:
    """io::copy — bounded-memory copy through a read()-style object."""
    while True:
        piece = reader.read(_CHUNK)
        if not piece:
            return
        writer.write(piece)


def _run_streaming(args) -> int:
    """Bounded-memory paths for copy/byte-read/gzip/zlib subcommands."""
    from .formats import gzip as fgzip, zlib as fzlib

    with _open_in(args.input) as src, _open_out(args.output) as dst:
        if args.cmd == "copy":
            _pump(src, dst)
        elif args.cmd == "byte-read":
            unit = max(1, args.unit)
            while src.read(unit):
                pass
        elif args.cmd in ("gzip-decode", "gzip-decode-multi"):
            dec = (fgzip.MultiDecoder if args.cmd.endswith("multi")
                   else fgzip.Decoder)(src)
            if args.verbose:
                print(f"header: {dec.header}", file=sys.stderr)
            _pump(dec, dst)
        elif args.cmd == "zlib-decode":
            dec = fzlib.Decoder(src)
            if args.verbose:
                print(f"header: {dec.header}", file=sys.stderr)
            _pump(dec, dst)
        elif args.cmd == "gzip-encode":
            enc = fgzip.Encoder(sink=dst)
            _pump(src, _WriteAdapter(enc))
            enc.finish()
        elif args.cmd == "zlib-encode":
            enc = fzlib.Encoder(sink=dst)
            _pump(src, _WriteAdapter(enc))
            enc.finish()
        else:
            print(f"error: --stream does not support {args.cmd}",
                  file=sys.stderr)
            return 2
    return 0


class _WriteAdapter:
    """Minimal writer wrapper so _pump can feed an Encoder."""

    def __init__(self, enc) -> None:
        self._enc = enc

    def write(self, data: bytes) -> int:
        return self._enc.write(data)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="libflate-tpu",
        description="DEFLATE/GZIP/ZLIB codec tool (host and device engines)")
    p.add_argument("-i", "--input", default="-")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--engine", default=None,
                   help="serial | native | tpu | auto")
    p.add_argument("--stream", action="store_true",
                   help="bounded-memory streaming codecs (chunked "
                        "decoders / BlockStreamer encoder)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("copy")
    br = sub.add_parser("byte-read")
    br.add_argument("--unit", type=int, default=1)
    sub.add_parser("gzip-decode")
    sub.add_parser("gzip-decode-multi")
    sub.add_parser("gzip-encode")
    sub.add_parser("zlib-decode")
    sub.add_parser("zlib-encode")
    pe = sub.add_parser("pgzf-encode")
    pe.add_argument("--member-size", type=int, default=64 * 1024)
    sub.add_parser("pgzf-decode")

    args = p.parse_args(argv)

    if args.stream:
        return _run_streaming(args)

    data = _read_input(args.input)

    from .formats import gzip as fgzip, pgzf, zlib as fzlib

    if args.cmd == "copy":
        out = data
    elif args.cmd == "byte-read":
        # parity: reads input unit bytes at a time, discards (throughput
        # probe); output is empty
        unit = max(1, args.unit)
        for _ in range(0, len(data), unit):
            pass
        out = b""
    elif args.cmd == "gzip-decode":
        dec = fgzip.Decoder(data, engine=args.engine)
        if args.verbose:
            print(f"header: {dec.header}", file=sys.stderr)
        out = dec.read()
    elif args.cmd == "gzip-decode-multi":
        out = fgzip.decompress(data, engine=args.engine, multi=True)
    elif args.cmd == "gzip-encode":
        out = fgzip.compress(data, engine=args.engine)
    elif args.cmd == "zlib-decode":
        dec = fzlib.Decoder(data, engine=args.engine)
        if args.verbose:
            print(f"header: {dec.header}", file=sys.stderr)
        out = dec.read()
    elif args.cmd == "zlib-encode":
        out = fzlib.compress(data, engine=args.engine)
    elif args.cmd == "pgzf-encode":
        out = pgzf.compress(data, member_size=args.member_size,
                            engine=args.engine)
    elif args.cmd == "pgzf-decode":
        out = pgzf.decompress(data, engine=args.engine)
    else:  # pragma: no cover
        p.error(f"unknown command {args.cmd}")

    _write_output(args.output, out)
    return 0


def run() -> int:
    """Entry point with clean one-line error reporting."""
    try:
        return main()
    except BrokenPipeError:
        return 0
    except (ValueError, OSError, EOFError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
