"""Pure-Python writer of flax's msgpack parameter files, the inverse of
:mod:`sdfest_torch.utils.msgpack_reader`.

It writes what ``flax.serialization.msgpack_serialize`` writes for a tree
of dicts with numpy leaves: the map keys sorted (flax rebuilds the tree with
``jax.tree_util.tree_map``), each ndarray as a msgpack extension of type 1
holding the packed ``(shape, dtype_name, C-order bytes)`` triple, each
numpy scalar as type 3, and every integer, string and container in
msgpack's smallest encoding, so a model the port trains loads in both
packages without ``msgpack`` or ``flax``.  Arrays above flax's 1 GiB chunk
size are refused.
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np

from sdfest_torch.utils.msgpack_reader import _EXT_NDARRAY, _EXT_NPSCALAR

_MAX_ARRAY_BYTES = 2 ** 30


def _sized(out: bytearray, n: int, small: int, small_max: int, codes) -> None:
    """A length header: ``small | n`` up to ``small_max``, else the 8-,
    16- or 32-bit form (``codes``, ``None`` where msgpack has none)."""
    if small is not None and n <= small_max:
        out.append(small | n)
    elif codes[0] is not None and n < 2 ** 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 2 ** 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    for fmt, code, lo, hi in (
            (">BB", 0xCC, 0, 2 ** 8), (">BH", 0xCD, 0, 2 ** 16),
            (">BI", 0xCE, 0, 2 ** 32), (">BQ", 0xCF, 0, 2 ** 64),
            (">Bb", 0xD0, -2 ** 7, 2 ** 7), (">Bh", 0xD1, -2 ** 15, 2 ** 15),
            (">Bi", 0xD2, -2 ** 31, 2 ** 31), (">Bq", 0xD3, -2 ** 63,
                                               2 ** 63)):
        if lo <= v < hi:
            out += struct.pack(fmt, code, v)
            return
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out += struct.pack(">Bb", fixed[len(data)], code)
    else:
        _sized(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not supported")
    if arr.nbytes > _MAX_ARRAY_BYTES:
        raise ValueError("arrays above 1 GiB are chunked by flax; not "
                         "supported")
    return packb((tuple(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: bytearray, obj: Any) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, np.ndarray):
        _ext(out, _EXT_NDARRAY, _ndarray_bytes(obj))
    elif isinstance(obj, np.generic):
        _ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _sized(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _sized(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _sized(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif isinstance(obj, dict):
        _sized(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _pack(out, k)
            _pack(out, obj[k])
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """msgpack bytes of ``obj`` (the encoding of ``msgpack.packb(obj,
    use_bin_type=True)``, dict keys sorted)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def save(path: str, tree: Any) -> None:
    """Write a nested dict of numpy arrays as a flax msgpack file."""
    with open(path, "wb") as f:
        f.write(packb(tree))
