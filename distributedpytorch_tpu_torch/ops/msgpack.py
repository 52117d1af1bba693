"""The msgpack subset of flax's serialization, on ``struct`` alone.

The JAX package writes its checkpoints with
``flax.serialization.msgpack_serialize`` and reads them with
``msgpack_restore``. The port reads and writes the same bytes without the
``msgpack`` or ``flax`` packages (the card's machine has neither):

* nil, bool, every int width, float32 and float64, str, bin, array and
  map, as ``msgpack.packb(use_bin_type=True)`` writes them, each in its
  smallest encoding and a map's keys sorted, so a tree encodes to the
  bytes flax gives it;
* ext type 1, an array: the inner msgpack ``[shape, dtype name, C-order
  bytes]``, decoded to a CPU ``torch.Tensor`` (``"bfloat16"`` through an
  ``int16`` view, as numpy has no bfloat16 of its own);
* ext type 3, a numpy scalar, packed as an array: decoded to a 0-d
  tensor.

Ext type 2 (a Python complex) raises, and so does flax's chunked leaf
(``{"__msgpack_chunked_array__": True, ...}``, written for arrays over
``MAX_CHUNK_SIZE`` bytes): no array of these models comes near it.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

#: flax chunks a leaf above this many bytes (``MAX_CHUNK_SIZE``)
MAX_CHUNK_SIZE = 2**30
EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_BY_NAME = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


class MsgpackError(ValueError):
    """Bytes this codec cannot decode, or a value it cannot encode."""


# -- encoding ------------------------------------------------------------------


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} exceeds 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise MsgpackError(f"integer {n} exceeds 64 bits")


def _pack_len(n: int, out: bytearray, fix: Tuple[int, int],
              codes: Tuple[int, ...]) -> None:
    """A length header: ``fix = (base, limit)`` for the fix form (or
    ``(None, 0)``), then the 8-, 16- and 32-bit forms of ``codes``."""
    base, limit = fix
    if base is not None and n < limit:
        out.append(base | n)
        return
    widths = ((">B", 1 << 8), (">H", 1 << 16), (">I", 1 << 32))
    for code, (fmt, top) in zip(codes, widths[3 - len(codes):]):
        if n < top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise MsgpackError(f"length {n} exceeds 32 bits")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    n = len(data)
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, (None, 0), (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data


def _array_bytes(t) -> bytes:
    """The inner msgpack of an array: ``[shape, dtype name, bytes]``."""
    if isinstance(t, np.ndarray):
        shape, name = list(t.shape), t.dtype.name
        raw = np.ascontiguousarray(t).tobytes()
    else:
        t = t.detach().cpu().contiguous()
        name = _NAME_BY_TORCH.get(t.dtype)
        if name is None:
            raise MsgpackError(f"no msgpack dtype name for {t.dtype}")
        shape = list(t.shape)
        host = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        raw = host.numpy().tobytes()
    if len(raw) > MAX_CHUNK_SIZE:
        raise MsgpackError(
            f"an array of {len(raw)} bytes would be a chunked leaf "
            f"(> {MAX_CHUNK_SIZE}), which this codec does not write")
    return packb([shape, name, raw])


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.generic):
        # before int and float: np.float64 is a float, and flax packs a
        # numpy scalar as ext 3
        _pack_ext(EXT_NPSCALAR, _array_bytes(np.asarray(obj)), out)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, (None, 0), (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, (0x90, 16), (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, (0x80, 16), (0xDE, 0xDF))
        # sorted, as flax's copy of the tree (``jax.tree_util.tree_map``)
        # leaves a dict's keys
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _pack_ext(EXT_NDARRAY, _array_bytes(obj), out)
    else:
        raise MsgpackError(f"cannot encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """``obj`` (a tree of dicts, lists, scalars, strings, bytes, tensors
    and numpy arrays) as msgpack bytes, as
    ``flax.serialization.msgpack_serialize`` writes it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -- decoding ------------------------------------------------------------------


def _tensor_from(data: bytes) -> torch.Tensor:
    shape, name, raw = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode("utf-8")
    dtype = _TORCH_BY_NAME.get(name)
    if dtype is None:
        raise MsgpackError(f"array of unsupported dtype {name!r}")
    buf = bytearray(raw)
    if dtype == torch.bfloat16:
        flat = (torch.frombuffer(buf, dtype=torch.int16).view(torch.bfloat16)
                if buf else torch.empty(0, dtype=dtype))
    else:
        flat = (torch.frombuffer(buf, dtype=dtype) if buf
                else torch.empty(0, dtype=dtype))
    return flat.reshape([int(s) for s in shape])


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise MsgpackError("truncated msgpack data")
        out = self.data[self.at:self.at + n].tobytes()
        self.at += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _tensor_from(data)
        if code == EXT_NPSCALAR:
            return _tensor_from(data).reshape(())
        if code == EXT_COMPLEX:
            raise MsgpackError("ext type 2 (complex) is not supported")
        raise MsgpackError(f"unknown ext type {code}")

    def value(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if b in ints:
            return self.unpack(ints[b])
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",      # bin
                0xD9: ">B", 0xDA: ">H", 0xDB: ">I",      # str
                0xDC: ">H", 0xDD: ">I",                  # array
                0xDE: ">H", 0xDF: ">I",                  # map
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}      # ext
        if b in lens:
            n = self.unpack(lens[b])
            if b <= 0xC6:
                return self.take(n)
            if b <= 0xC9:
                return self.ext(n)
            if b <= 0xDB:
                return self.take(n).decode("utf-8")
            if b <= 0xDD:
                return [self.value() for _ in range(n)]
            return self.map(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        raise MsgpackError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED in out:
            raise MsgpackError(
                "a chunked array leaf (flax writes one for an array over "
                f"{MAX_CHUNK_SIZE} bytes) is not supported")
        return out


def unpackb(data: bytes) -> Any:
    """msgpack bytes → the tree ``flax.serialization.msgpack_restore``
    gives, with every array a CPU ``torch.Tensor``. Raises
    ``MsgpackError`` for bytes it cannot decode, trailing bytes
    included."""
    reader = _Reader(data)
    out = reader.value()
    if reader.at != len(reader.data):
        raise MsgpackError(
            f"{len(reader.data) - reader.at} bytes after the msgpack value")
    return out
