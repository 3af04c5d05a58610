"""Reads the JAX package's msgpack checkpoints without flax or msgpack
(counterpart of flax.serialization.msgpack_restore, which
cfen_vit_tpu/train/checkpoint.py `load_net` calls).

The JAX package writes `<epoch>_net_<name>.msgpack` with
`flax.serialization.msgpack_serialize` of a tree of dicts and lists whose
leaves are numpy arrays.  The file is plain msgpack:

  * a dict is a map with str keys, a list (or tuple) an array;
  * an ndarray is ext type 1, whose payload is itself msgpack of
    (shape, dtype name, the C-order bytes); ext type 3 is a numpy scalar
    in the same form, ext type 2 a complex as (real, imag);
  * an array over flax's MAX_CHUNK_SIZE (2**30 bytes) is a map
    {"__msgpack_chunked_array__": True, "shape": {"0": d0, ...},
     "chunks": {"0": flat chunk, ...}}, joined again here.

`bfloat16` is stored under that name; numpy has no such dtype, so those
arrays come back as torch.bfloat16 tensors (the bytes read through a
uint16 view).  Every other array is a read-only numpy view of the file's
bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """A msgpack decoder over one buffer (the subset flax writes, which is
    every msgpack type but timestamps)."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):        # bin 8/16/32
            return self._take(self._unpack(">" + "BHI"[b - 0xC4]))
        if b in (0xC7, 0xC8, 0xC9):        # ext 8/16/32
            n = self._unpack(">" + "BHI"[b - 0xC7])
            return self._ext(self._unpack(">b"), self._take(n))
        if b == 0xCA:
            return self._unpack(">f")
        if b == 0xCB:
            return self._unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self._unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self._unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:              # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, self._take(1 << (b - 0xD4)))
        if 0xD9 <= b <= 0xDB:
            return str(self._take(self._unpack(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self._array(self._unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self._map(self._unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def _array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def _ext(self, code: int, payload: memoryview):
        if code == EXT_NDARRAY:
            return _ndarray(payload)
        if code == EXT_NPSCALAR:
            a = _ndarray(payload)
            return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
        if code == EXT_COMPLEX:
            re, im = _Reader(payload).value()
            return complex(re, im)
        raise ValueError(f"msgpack: unknown ext type {code}")


def _ndarray(payload: memoryview):
    shape, name, data = _Reader(payload).value()
    shape: Tuple[int, ...] = tuple(shape)
    if name == "bfloat16":
        bits = np.frombuffer(data, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _join(chunked: dict):
    shape = tuple(chunked["shape"][str(i)] for i in range(len(chunked["shape"])))
    parts = [chunked["chunks"][str(i)] for i in range(len(chunked["chunks"]))]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts).reshape(shape)
    return np.concatenate(parts).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _join(tree)
        return {k: _unchunk(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    return tree


def restore(data) -> Any:
    """msgpack bytes of flax.serialization.msgpack_serialize -> the tree."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes "
                         "after the tree")
    return _unchunk(tree)


def load(path: str) -> Any:
    with open(path, "rb") as fh:
        return restore(fh.read())


def as_numpy(tree):
    """The tree with its bfloat16 leaves widened to float32 numpy (exact),
    as the numpy bridge of interop/from_jax.py takes it."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [as_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree
