"""The MessagePack subset the RPC wire speaks, without the ``msgpack``
package.

:func:`packb` gives the bytes ``msgpack.packb(obj, use_bin_type=True)``
gives, and :func:`unpackb` reads what ``msgpack.unpackb(buf, raw=False)``
reads, for these types:

- ``None``, ``bool``;
- ``int`` from -2**63 to 2**64 - 1, in the smallest encoding (positive
  fixint, uint8-64, negative fixint, int8-64);
- ``float`` as float64 (float32 is read, never written);
- ``str`` (fixstr, str8-32) and ``bytes`` / ``bytearray`` / ``memoryview``
  as bin8-32, read back as ``bytes``;
- ``list`` and ``tuple`` as arrays (read back as lists);
- ``dict`` as a map in insertion order; on reading, a key that is not
  ``str`` or ``bytes`` raises, as msgpack's ``strict_map_key`` does.

Anything else raises ``TypeError`` on packing; ext types, truncated input
and trailing bytes raise ``ValueError`` on unpacking.
"""

import struct
from typing import Any, Tuple

_B = struct.Struct(">B").pack
_H = struct.Struct(">H").pack
_I = struct.Struct(">I").pack
_Q = struct.Struct(">Q").pack
_b = struct.Struct(">b").pack
_h = struct.Struct(">h").pack
_i = struct.Struct(">i").pack
_q = struct.Struct(">q").pack
_d = struct.Struct(">d").pack


def _pack_int(x: int, out: bytearray):
    if 0 <= x < 0x80:
        out.append(x)
    elif -0x20 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + _B(x)
    elif -0x80 <= x < 0:
        out += b"\xd0" + _b(x)
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + _H(x)
    elif -0x8000 <= x < 0:
        out += b"\xd1" + _h(x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + _I(x)
    elif -0x80000000 <= x < 0:
        out += b"\xd2" + _i(x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + _Q(x)
    elif -0x8000000000000000 <= x < 0:
        out += b"\xd3" + _q(x)
    else:
        raise OverflowError("Integer value out of range")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, c8,
              c16: bytes, c32: bytes, what: str):
    if n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n <= 0xFF:
        out += c8 + _B(n)
    elif n <= 0xFFFF:
        out += c16 + _H(n)
    elif n <= 0xFFFFFFFF:
        out += c32 + _I(n)
    else:
        raise ValueError(f"{what} is too large")


def _pack(obj: Any, out: bytearray):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + _d(obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), out, 0xA0, 32, b"\xd9", b"\xda", b"\xdb", "str")
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        if n <= 0xFF:
            out += b"\xc4" + _B(n)
        elif n <= 0xFFFF:
            out += b"\xc5" + _H(n)
        elif n <= 0xFFFFFFFF:
            out += b"\xc6" + _I(n)
        else:
            raise ValueError("bin is too large")
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, None, b"\xdc", b"\xdd", "array")
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, None, b"\xde", b"\xdf", "map")
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# fixed-width headers: code -> (struct, byte count)
_U8 = struct.Struct(">B")
_U16 = struct.Struct(">H")
_U32 = struct.Struct(">I")
_SCALARS = {
    0xCA: struct.Struct(">f"), 0xCB: struct.Struct(">d"),
    0xCC: _U8, 0xCD: _U16, 0xCE: _U32, 0xCF: struct.Struct(">Q"),
    0xD0: struct.Struct(">b"), 0xD1: struct.Struct(">h"),
    0xD2: struct.Struct(">i"), 0xD3: struct.Struct(">q"),
}
# code -> (kind, length header)
_SIZED = {
    0xC4: ("bin", _U8), 0xC5: ("bin", _U16), 0xC6: ("bin", _U32),
    0xD9: ("str", _U8), 0xDA: ("str", _U16), 0xDB: ("str", _U32),
    0xDC: ("array", _U16), 0xDD: ("array", _U32),
    0xDE: ("map", _U16), 0xDF: ("map", _U32),
}


def _take(buf: memoryview, pos: int, n: int) -> int:
    end = pos + n
    if end > len(buf):
        raise ValueError("Unpack failed: incomplete input")
    return end


def _unpack(buf: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("Unpack failed: incomplete input")
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if c <= 0x8F:
        kind, n = "map", c & 0x0F
    elif c <= 0x9F:
        kind, n = "array", c & 0x0F
    elif c <= 0xBF:
        kind, n = "str", c & 0x1F
    elif c == 0xC0:
        return None, pos
    elif c == 0xC2:
        return False, pos
    elif c == 0xC3:
        return True, pos
    elif c in _SCALARS:
        st = _SCALARS[c]
        end = _take(buf, pos, st.size)
        return st.unpack_from(buf, pos)[0], end
    elif c in _SIZED:
        kind, st = _SIZED[c]
        end = _take(buf, pos, st.size)
        n = st.unpack_from(buf, pos)[0]
        pos = end
    else:
        raise ValueError(f"Unpack failed: unsupported type code 0x{c:02x}")
    if kind == "str":
        end = _take(buf, pos, n)
        return str(buf[pos:end], "utf-8"), end
    if kind == "bin":
        end = _take(buf, pos, n)
        return bytes(buf[pos:end]), end
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    d = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        if type(k) not in (str, bytes):
            raise ValueError(
                f"{type(k).__name__} is not allowed for map key when "
                f"strict_map_key=True")
        v, pos = _unpack(buf, pos)
        d[k] = v
    return d, pos


def unpackb(buf) -> Any:
    """``msgpack.unpackb(buf, raw=False)`` for the subset above; ``buf``
    is any bytes-like object (a ``memoryview`` is read without a copy)."""
    view = memoryview(buf)
    if view.format != "B" or view.ndim != 1:
        view = view.cast("B")
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError("Unpack failed: extra data")
    return obj
