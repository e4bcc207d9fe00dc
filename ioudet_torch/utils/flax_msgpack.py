"""A reader of flax's msgpack checkpoints (``flax.serialization.to_bytes``),
written out so that the port needs neither ``msgpack`` nor ``flax``.

msgpack: every value starts with one byte that gives its type and, for the
small forms, its length or value.  Maps, arrays, strings, binary, integers,
floats, nil and booleans are read here, and the ext types flax writes:

  * 1, an ndarray: the payload is itself msgpack, ``(shape, dtype name,
    C-order bytes)``;
  * 2, a Python complex: ``(real, imag)``;
  * 3, a numpy scalar: an ndarray payload of shape ().

flax stores an array larger than ``MAX_CHUNK_SIZE`` bytes as a dict
``{'__msgpack_chunked_array__': True, 'shape': {'0': ..}, 'chunks': {'0':
..}}``; ``msgpack_restore`` joins the chunks back into the array, as flax's
does.  Array leaves come back as numpy arrays, except ``bfloat16`` ones,
which numpy cannot hold: those are ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

NDARRAY, NATIVE_COMPLEX, NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    pass


def _array(shape, dtype_name, buf: bytes):
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    shape = tuple(int(d) for d in shape)
    if name == "bfloat16":
        flat = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16) if buf else \
            torch.empty(0, dtype=torch.bfloat16)
        return flat.reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"array of dtype {name!r}: not readable without ml_dtypes") from e
    return np.frombuffer(buf, dtype=dtype).reshape(shape).copy()


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise MsgpackError(f"truncated: {n} bytes wanted at offset {self.pos}")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def value(self) -> Any:
        b = self.unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "array"), 0xDD: ("I", "array"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "ext":
                return self.ext(self.unpack("b"), self.take(n))
            return self.array(n) if kind == "array" else self.map(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:   # fixext 1, 2, 4, 8, 16
            code = self.unpack("b")
            return self.ext(code, self.take(1 << (b - 0xD4)))
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x} at offset {self.pos - 1}")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, payload: bytes):
        if code == NDARRAY:
            return _array(*unpackb(payload))
        if code == NPSCALAR:
            arr = _array(*unpackb(payload))
            return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
        if code == NATIVE_COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise MsgpackError(f"unknown ext type {code}")


def unpackb(data: bytes) -> Any:
    """One msgpack value (the whole of ``data``), with flax's ext types."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise MsgpackError(f"{len(reader.data) - reader.pos} bytes after the value")
    return out


def _ordered(d: dict) -> list:
    """A flax list-as-dict {'0': .., '1': ..} as a list."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d: dict):
    shape = tuple(int(s) for s in _ordered(d["shape"]))
    chunks = _ordered(d["chunks"])
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate([np.asarray(c).reshape(-1) for c in chunks]).reshape(shape)


def _unchunk_tree(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_tree(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` returns for bytes of
    ``to_bytes``: nested dicts (lists and tuples were written as dicts with
    keys '0', '1', ...) of arrays and Python scalars."""
    return _unchunk_tree(unpackb(data))

