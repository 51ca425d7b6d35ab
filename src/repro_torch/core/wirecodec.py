"""Wire codecs: how broker frames and task files become bytes.

The broker wire (core/netbroker.py) originally round-tripped every frame
— including float sample payloads — as length-prefixed JSON text.  For
the array-heavy traffic the ML-in-the-loop ensembles actually generate
(sample vectors, observable slices), text float formatting/parsing
dominates the transport cost end to end.  This module adds a compact
binary codec negotiated per connection, with JSON kept as the
compatibility floor so mixed-codec fleets interoperate and a rolling
upgrade never bricks a federation.

Two codecs, one interface (``encode(obj) -> bytes`` / ``decode(data) ->
obj``):

* :class:`JsonCodec` (``"json"``) — the historical format and the floor
  every peer speaks.  A connection starts in JSON and stays there unless
  a handshake upgrades it.
* :class:`BinCodec` (``"bin1"``) — a flat tag+varint binary encoding of
  the same JSON-shaped objects.  Scalars are tagged values (ints as
  zigzag varints, float64 as 8 raw little-endian bytes); strings/bytes
  are length-prefixed; lists/dicts are count-prefixed.  The payoff tags:
  a homogeneous list of Python floats is carried as ONE raw
  little-endian float64 buffer (``struct.pack``/``unpack`` — C speed,
  no text), and numpy arrays are carried as dtype + shape + raw
  C-contiguous bytes (used by the shm bundle ring, core/shmring.py).
  ``bin1`` round-trips every value JSON can carry, plus ``bytes`` and
  ``np.ndarray``.

Decoding is defensive: every length/count is bounds-checked against the
remaining buffer before allocation, unknown tags, truncation, trailing
garbage, and over-deep nesting all raise :class:`CodecError` — a frame
of corrupt bytes produces a typed error, never a hang or an
interpreter-level blowup (the chaos fuzz tests bit-flip real frames and
assert exactly this).

Negotiation (:func:`negotiate_codec`) picks the first client preference
the server also supports, falling back to ``"json"``; the handshake
itself always travels in JSON (core/netbroker.py documents the hello
op).  The FileBroker's v2 task-file format reuses ``bin1`` behind a
leading format-version byte (see ``core/queue.py``).
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


class CodecError(ValueError):
    """A frame or file could not be decoded (corrupt, truncated, or not
    in the negotiated format).  Typed so transports can quarantine the
    frame — reply with a structured error / dead-letter the file —
    instead of killing the connection or redelivering forever."""


# ---------------------------------------------------------------------------
# JSON codec (the compatibility floor)
# ---------------------------------------------------------------------------

def _json_default(obj: Any) -> Any:
    # array payloads must survive a fallback-to-JSON connection (mixed
    # fleet, failed upgrade): ndarrays degrade to nested lists — text,
    # slow, but correct.  bin1 keeps them as raw buffers.
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating, np.bool_)):
        return obj.item()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


class JsonCodec:
    name = "json"

    @staticmethod
    def encode(obj: Any) -> bytes:
        return json.dumps(obj, default=_json_default).encode("utf-8")

    @staticmethod
    def decode(data: bytes) -> Any:
        try:
            return json.loads(data.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CodecError(f"bad JSON frame: {e}") from e


# ---------------------------------------------------------------------------
# bin1: flat tag + varint binary codec
# ---------------------------------------------------------------------------

_T_NONE = 0x00
_T_FALSE = 0x01
_T_TRUE = 0x02
_T_INT = 0x03      # zigzag varint (unbounded)
_T_F64 = 0x04      # 8 bytes LE double
_T_STR = 0x05      # varint byte length + utf8
_T_BYTES = 0x06    # varint length + raw
_T_LIST = 0x07     # varint count + items
_T_DICT = 0x08     # varint count + (key, value) pairs
_T_F64ARR = 0x09   # varint count + count * 8 bytes LE double -> list[float]
_T_NDARR = 0x0A    # dtype str + varint ndim + shape varints + raw C bytes

_MAX_DEPTH = 64


def _pack_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _pack_zigzag(out: bytearray, v: int) -> None:
    _pack_varint(out, (v << 1) if v >= 0 else ((-v << 1) - 1))


def _enc(out: bytearray, obj: Any, depth: int) -> None:
    if depth > _MAX_DEPTH:
        raise CodecError(f"nesting deeper than {_MAX_DEPTH}")
    t = type(obj)
    if t is str:
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        _pack_varint(out, len(raw))
        out += raw
    elif t is bool:
        out.append(_T_TRUE if obj else _T_FALSE)
    elif t is int:
        out.append(_T_INT)
        _pack_zigzag(out, obj)
    elif t is float:
        out.append(_T_F64)
        out += struct.pack("<d", obj)
    elif t is dict:
        out.append(_T_DICT)
        _pack_varint(out, len(obj))
        for k, v in obj.items():
            _enc(out, k, depth + 1)
            _enc(out, v, depth + 1)
    elif t is list or t is tuple:
        n = len(obj)
        if n and type(obj[0]) is float:
            # the payoff path: a homogeneous float list travels as ONE
            # raw LE float64 buffer instead of n formatted text numbers
            for x in obj:
                if type(x) is not float:
                    break
            else:
                out.append(_T_F64ARR)
                _pack_varint(out, n)
                out += struct.pack(f"<{n}d", *obj)
                return
        out.append(_T_LIST)
        _pack_varint(out, n)
        for v in obj:
            _enc(out, v, depth + 1)
    elif obj is None:
        out.append(_T_NONE)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")
        out.append(_T_NDARR)
        _pack_varint(out, len(dt))
        out += dt
        _pack_varint(out, arr.ndim)
        for d in arr.shape:
            _pack_varint(out, d)
        out += arr.tobytes()
    elif t is bytes or t is bytearray:
        out.append(_T_BYTES)
        _pack_varint(out, len(obj))
        out += obj
    elif isinstance(obj, (bool, np.bool_)):  # bool subclasses + numpy bool_
        out.append(_T_TRUE if obj else _T_FALSE)
    elif isinstance(obj, (int, np.integer)):
        out.append(_T_INT)
        _pack_zigzag(out, int(obj))
    elif isinstance(obj, (float, np.floating)):
        out.append(_T_F64)
        out += struct.pack("<d", float(obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        _pack_varint(out, len(raw))
        out += raw
    elif isinstance(obj, (list, tuple)):
        out.append(_T_LIST)
        _pack_varint(out, len(obj))
        for v in obj:
            _enc(out, v, depth + 1)
    elif isinstance(obj, dict):
        out.append(_T_DICT)
        _pack_varint(out, len(obj))
        for k, v in obj.items():
            _enc(out, k, depth + 1)
            _enc(out, v, depth + 1)
    else:
        raise CodecError(f"bin1 cannot encode {type(obj).__name__}")


def _read_varint(data: bytes, off: int, end: int) -> Tuple[int, int]:
    # no length cap: ints are unbounded (JSON parity) and the frame end
    # bounds the worst case; counts are sanity-checked by the callers
    n = 0
    shift = 0
    while True:
        if off >= end:
            raise CodecError("truncated varint")
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _dec(data: bytes, off: int, end: int, depth: int) -> Tuple[Any, int]:
    if depth > _MAX_DEPTH:
        raise CodecError(f"nesting deeper than {_MAX_DEPTH}")
    if off >= end:
        raise CodecError("truncated frame")
    tag = data[off]
    off += 1
    if tag == _T_STR:
        n, off = _read_varint(data, off, end)
        if n > end - off:
            raise CodecError("string length past end of frame")
        try:
            s = data[off:off + n].decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"bad utf8 in string: {e}") from e
        return s, off + n
    if tag == _T_INT:
        u, off = _read_varint(data, off, end)
        return (u >> 1) if not (u & 1) else -((u + 1) >> 1), off
    if tag == _T_F64:
        if 8 > end - off:
            raise CodecError("truncated float64")
        return struct.unpack_from("<d", data, off)[0], off + 8
    if tag == _T_DICT:
        n, off = _read_varint(data, off, end)
        if n > (end - off):  # each entry needs >= 2 bytes; cheap bound
            raise CodecError("dict count past end of frame")
        d: Dict[Any, Any] = {}
        for _ in range(n):
            k, off = _dec(data, off, end, depth + 1)
            v, off = _dec(data, off, end, depth + 1)
            try:
                d[k] = v
            except TypeError as e:  # corrupt frame decoded a list/array key
                raise CodecError(f"unhashable dict key: {e}") from e
        return d, off
    if tag == _T_LIST:
        n, off = _read_varint(data, off, end)
        if n > end - off:  # each item needs >= 1 byte
            raise CodecError("list count past end of frame")
        out: List[Any] = []
        for _ in range(n):
            v, off = _dec(data, off, end, depth + 1)
            out.append(v)
        return out, off
    if tag == _T_F64ARR:
        n, off = _read_varint(data, off, end)
        if 8 * n > end - off:
            raise CodecError("float array past end of frame")
        return list(struct.unpack_from(f"<{n}d", data, off)), off + 8 * n
    if tag == _T_NONE:
        return None, off
    if tag == _T_TRUE:
        return True, off
    if tag == _T_FALSE:
        return False, off
    if tag == _T_BYTES:
        n, off = _read_varint(data, off, end)
        if n > end - off:
            raise CodecError("bytes length past end of frame")
        return bytes(data[off:off + n]), off + n
    if tag == _T_NDARR:
        n, off = _read_varint(data, off, end)
        if n > end - off or n > 16:
            raise CodecError("bad ndarray dtype")
        try:
            dt = np.dtype(data[off:off + n].decode("ascii"))
        except (UnicodeDecodeError, TypeError, ValueError) as e:
            raise CodecError(f"bad ndarray dtype: {e}") from e
        off += n
        ndim, off = _read_varint(data, off, end)
        if ndim > 32:
            raise CodecError("ndarray rank too large")
        shape = []
        count = 1
        for _ in range(ndim):
            d, off = _read_varint(data, off, end)
            shape.append(d)
            count *= d
        nbytes = count * dt.itemsize
        if nbytes > end - off:
            raise CodecError("ndarray data past end of frame")
        # bytes() copy: the result must not alias the (reused) recv buffer
        arr = np.frombuffer(bytes(data[off:off + nbytes]),
                            dtype=dt).reshape(shape)
        return arr, off + nbytes
    raise CodecError(f"unknown bin1 tag 0x{tag:02x}")


class BinCodec:
    name = "bin1"

    @staticmethod
    def encode(obj: Any) -> bytes:
        out = bytearray()
        _enc(out, obj, 0)
        return bytes(out)

    @staticmethod
    def decode(data: bytes) -> Any:
        data = bytes(data)
        obj, off = _dec(data, 0, len(data), 0)
        if off != len(data):
            raise CodecError(f"{len(data) - off} trailing bytes after frame")
        return obj


JSON_CODEC = JsonCodec()
BIN_CODEC = BinCodec()

# preference-ordered registry; "json" is the floor every peer speaks
CODECS: Dict[str, Any] = {"bin1": BIN_CODEC, "json": JSON_CODEC}
DEFAULT_PREFERENCE: Tuple[str, ...] = ("bin1", "json")


def get_codec(name: str):
    try:
        return CODECS[name]
    except KeyError:
        raise ValueError(f"unknown wire codec {name!r} "
                         f"(available: {sorted(CODECS)})") from None


def negotiate_codec(server: Sequence[str], client: Iterable[str]) -> str:
    """First client preference the server supports; ``"json"`` floor."""
    server_set = set(server) | {"json"}
    for name in client:
        if name in server_set and name in CODECS:
            return name
    return "json"
