"""Numpy-only safetensors reader and writer.

The reader is the pure-numpy path of asvd4llm_tpu/utils/tensorio.py: parse
the 8-byte little-endian header length and the JSON header, bound-check
every tensor's byte range against the file, and view the bytes as numpy
(bf16 widened to f32 by bit shift). The writer produces the same format
(header padded with spaces to an 8-byte boundary), so checkpoints need
neither torch's serializer nor the ``safetensors`` package.
"""

from __future__ import annotations

import glob
import json
import os
import struct

import numpy as np

_ST_DTYPES = {
    "F32": (np.float32, 4), "F16": (np.float16, 2), "BF16": (None, 2),
    "I64": (np.int64, 8), "I32": (np.int32, 4), "I16": (np.int16, 2),
    "I8": (np.int8, 1), "U8": (np.uint8, 1), "BOOL": (np.bool_, 1),
    "F64": (np.float64, 8),
}
_NP_TAGS = {np.dtype(v[0]): k for k, v in _ST_DTYPES.items() if v[0] is not None}


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def f32_to_bf16_bits(arr: np.ndarray) -> np.ndarray:
    """float32 -> uint16 bf16 bit patterns (round to nearest even)."""
    bits = np.ascontiguousarray(arr, np.float32).view(np.uint32)
    lsb = (bits >> 16) & 1
    return ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)


class SafetensorsFile:
    """Reader for one .safetensors file (memory-mapped)."""

    def __init__(self, path: str):
        self.path = path
        self._mm = np.memmap(path, dtype=np.uint8, mode="r")
        (hdr_len,) = struct.unpack("<Q", bytes(self._mm[:8]))
        if hdr_len > self._mm.size - 8:
            raise ValueError(f"{path}: corrupt safetensors header (len "
                             f"{hdr_len} exceeds file size {self._mm.size})")
        self.header = json.loads(bytes(self._mm[8:8 + hdr_len]))
        self.header.pop("__metadata__", None)
        self._data_start = 8 + hdr_len

    def keys(self):
        return list(self.header)

    def tensor(self, name: str, *, to_f32: bool = True) -> np.ndarray:
        info = self.header[name]
        tag = info["dtype"]
        shape = tuple(info["shape"])
        b0, b1 = info["data_offsets"]
        np_dtype, itemsize = _ST_DTYPES[tag]
        expect = int(np.prod(shape, dtype=np.int64)) * itemsize
        if not 0 <= b0 <= b1 or b1 - b0 != expect:
            raise ValueError(f"{self.path}: {name!r} byte range ({b0}, {b1}) "
                             f"!= shape {shape} x itemsize {itemsize}")
        off = self._data_start + b0
        if off + expect > self._mm.size:
            raise ValueError(f"{self.path}: {name!r} exceeds the file size")
        raw = np.array(self._mm[off:off + expect])  # a writable copy
        if tag == "BF16":
            bits = raw.view(np.uint16)
            arr = bf16_bits_to_f32(bits) if to_f32 else bits
        else:
            arr = raw.view(np_dtype)
            if to_f32 and tag == "F16":
                arr = arr.astype(np.float32)
        return arr.reshape(shape)

    def close(self):
        self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def load_safetensors_state_dict(model_dir: str, *, to_f32: bool = True) -> dict:
    """All .safetensors shards of a checkpoint dir as {name: np.ndarray}."""
    files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {model_dir}")
    sd = {}
    for path in files:
        with SafetensorsFile(path) as f:
            for k in f.keys():
                sd[k] = f.tensor(k, to_f32=to_f32)
    return sd


def write_safetensors(path: str, entries, *, metadata: dict | None = None):
    """Write one .safetensors file from ``entries``, a list of
    (name, dtype tag, shape, producer): the header is written first from
    the tags and shapes, then each ``producer()`` is called in turn and its
    array written, so a caller can hand over one tensor at a time (a model
    larger than host memory streams through). ``metadata`` becomes the
    header's ``__metadata__`` block (string keys and values)."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, tag, shape, _ in entries:
        nbytes = int(np.prod(shape, dtype=np.int64)) * _ST_DTYPES[tag][1]
        header[name] = {"dtype": tag, "shape": [int(d) for d in shape],
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, _, _, produce in entries:
            arr = np.ascontiguousarray(produce())
            b0, b1 = header[name]["data_offsets"]
            if arr.nbytes != b1 - b0:
                raise ValueError(f"{path}: {name!r} produced {arr.nbytes} bytes, "
                                 f"not the {header[name]['shape']} it announced")
            f.write(arr.reshape(-1).view(np.uint8).data)


def save_safetensors(path: str, tensors: dict, *, bf16: frozenset = frozenset(),
                     metadata: dict | None = None):
    """Write {name: np.ndarray} as one .safetensors file. Names in ``bf16``
    must hold uint16 bf16 bit patterns (see f32_to_bf16_bits)."""
    write_safetensors(path, [
        (name, "BF16" if name in bf16 else _NP_TAGS[arr.dtype], arr.shape,
         lambda arr=arr: arr)
        for name, arr in tensors.items()], metadata=metadata)
