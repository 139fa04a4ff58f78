"""Msgpack checkpoints of nested state, readable by the JAX package's
``checkpointing/checkpoint.py`` and able to read its files.

The reference encodes with the ``msgpack`` package and keeps bfloat16
through ``ml_dtypes``; the port needs neither.  Its codec writes and
reads the part of msgpack that ``_pack`` emits — maps with string keys,
str, bin, ints (fixint … 64-bit), float64 (float32 is read too), bool,
nil and arrays — choosing each value's smallest encoding as
``msgpack.packb(obj, use_bin_type=True)`` does, so the bytes match the
reference's for the same tree.

A leaf is stored as ``{"__arr__": True, "dtype": name, "shape": [...],
"data": raw bytes}`` with numpy's dtype name; a bfloat16 tensor goes
through torch's own dtype (its 16-bit words) as ``"bfloat16"``.  Lists
and tuples are ``{"__list__": [...], "__tuple__": bool}``.  ``load``
returns numpy arrays (host), and a bfloat16 leaf as a CPU torch tensor.
Saves are atomic and durable: a temporary file in the target's
directory, fsync, then ``os.replace``.
"""
from __future__ import annotations

import os
import struct
import tempfile
from typing import Any

import numpy as np
import torch

_ARR = "__arr__"


# ---------------------------------------------------------------------------
# msgpack: the encoder and decoder of the subset above
# ---------------------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if n >= 0:
        if n < 0x80:
            out.append(n)
        elif n <= 0xFF:
            out += b"\xcc" + struct.pack(">B", n)
        elif n <= 0xFFFF:
            out += b"\xcd" + struct.pack(">H", n)
        elif n <= 0xFFFFFFFF:
            out += b"\xce" + struct.pack(">I", n)
        elif n <= 0xFFFFFFFFFFFFFFFF:
            out += b"\xcf" + struct.pack(">Q", n)
        else:
            raise OverflowError(f"msgpack: integer {n} beyond uint64")
    elif n >= -32:
        out += struct.pack(">b", n)
    elif n >= -0x80:
        out += b"\xd0" + struct.pack(">b", n)
    elif n >= -0x8000:
        out += b"\xd1" + struct.pack(">h", n)
    elif n >= -0x80000000:
        out += b"\xd2" + struct.pack(">i", n)
    elif n >= -0x8000000000000000:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"msgpack: integer {n} beyond int64")


def _pack_len(n: int, fix: int, fix_max: int, codes: bytes,
              out: bytearray) -> None:
    """A str/bin/array/map header: the fix form when it fits, else the
    8-, 16- or 32-bit length form (``codes``; a zero byte where the type
    has no such form)."""
    if fix_max and n < fix_max:
        out.append(fix | n)
    elif codes[0] and n <= 0xFF:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes([codes[2]]) + struct.pack(">I", n)
    else:
        raise OverflowError(f"msgpack: length {n} beyond 2^32 - 1")


def _encode(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), 0, 0, b"\xc4\xc5\xc6", out)
        out += data
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, b"\x00\xde\xdf", out)
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, b"\x00\xdc\xdd", out)
        for v in obj:
            _encode(v, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj`` (None, bool, int, float, str, bytes, dict,
    list, tuple), each value in its smallest encoding."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
          0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LENS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H",
         0xC6: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _LENS:
            n = self.unpack(_LENS[b])
            if b in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xDC, 0xDD):
                return self.array(n)
            return self.map(n)
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """The object ``packb`` (or ``msgpack.packb(..., use_bin_type=True)``)
    encoded: bin as bytes, str as str, arrays as lists."""
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes")
    return obj


# ---------------------------------------------------------------------------
# trees <-> msgpack objects
# ---------------------------------------------------------------------------


def _array_record(a: np.ndarray, dtype_name: str) -> dict:
    return {_ARR: True, "dtype": dtype_name, "shape": list(a.shape),
            "data": np.ascontiguousarray(a).tobytes()}


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _array_record(t.view(torch.int16).numpy(), "bfloat16")
        return _array_record(t.numpy(), t.numpy().dtype.name)
    if isinstance(obj, (np.ndarray, np.generic)):
        # numpy scalars as 0-d arrays, so that their dtype survives
        a = np.asarray(obj)
        return _array_record(a, a.dtype.name)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return {"__list__": [_pack(v) for v in obj],
                "__tuple__": isinstance(obj, tuple)}
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    raise TypeError(f"unsupported checkpoint leaf: {type(obj)}")


def _unpack(obj):
    if isinstance(obj, dict):
        if obj.get(_ARR):
            shape = tuple(obj["shape"])
            if obj["dtype"] == "bfloat16":
                words = np.frombuffer(obj["data"], dtype=np.int16).copy()
                return torch.from_numpy(words).view(torch.bfloat16) \
                    .reshape(shape)
            a = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
            return a.reshape(shape).copy()
        if "__list__" in obj:
            items = [_unpack(v) for v in obj["__list__"]]
            return tuple(items) if obj.get("__tuple__") else items
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def save(path: str, tree: Any) -> None:
    payload = packb(_pack(tree))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
            # fsync before the rename: rename orders metadata, not data
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return _unpack(unpackb(f.read()))
