"""Safetensors files in plain Python with torch (port of
`finetrainers_tpu/utils/serialization.py`, which calls the `safetensors`
package; the port does not depend on it).

The format: an 8-byte little-endian header length, a JSON header that maps
each tensor name to its `dtype`, `shape` and `data_offsets` (begin and end in
the byte buffer after the header) and holds the string-to-string
`__metadata__`, then the tensors' little-endian bytes, back to back. The
header is padded with spaces to a multiple of 8 bytes, as the reference
writer pads it. The floating, integer and boolean dtypes that Hugging Face
checkpoints carry are supported (F64 ... BF16, the two fp8 types, I64 ... U8,
BOOL; a text tower's checkpoint holds I64 `position_ids` buffers, which the
JAX package's reader, the `safetensors` package, also reads), and a model
split into shards is read through its `*.safetensors.index.json`.
"""

from __future__ import annotations

import json
import math
import os
import struct
from typing import Dict, Optional

import torch

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
           "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {dtype: name for name, dtype in _DTYPES.items()}


def safetensors_save_dict(tensors: Dict[str, torch.Tensor], path: str,
                          metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device, any layout) and `metadata` to `path`: the
    header from the shapes, then each tensor's bytes as it reaches the host
    (one host copy at a time, written without a second copy)."""
    header, offset = {}, 0
    names = sorted(tensors)
    for name in names:
        tensor = tensors[name]
        if tensor.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {tensor.dtype} is not one of {sorted(_DTYPES)}")
        size = tensor.numel() * tensor.element_size()
        header[name] = {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    if metadata is not None:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    encoded = json.dumps(header, separators=(",", ":")).encode()
    encoded += b" " * (-len(encoded) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(encoded)))
        f.write(encoded)
        for name in names:
            f.write(tensors[name].detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)


def _read_header(f, path: str) -> dict:
    raw = f.read(8)
    if len(raw) < 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than its header length)")
    (header_len,) = struct.unpack("<Q", raw)
    header = f.read(header_len)
    if len(header) != header_len:
        raise ValueError(f"{path}: header length {header_len} exceeds the file")
    return json.loads(header)


def safetensors_load_dict(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, in the dtypes it stores. The
    tensors are views of one buffer the size of the file's data (no second
    copy of a model is made on the host)."""
    with open(path, "rb") as f:
        header = _read_header(f, path)
        buffer = bytearray(os.fstat(f.fileno()).st_size - f.tell())
        f.readinto(buffer)
    entries = sorted((item for item in header.items() if item[0] != "__metadata__"),
                     key=lambda item: item[1]["data_offsets"][0])
    out, end = {}, 0
    for name, info in entries:
        dtype = _DTYPES.get(info["dtype"])
        begin, stop = info["data_offsets"]
        shape = tuple(info["shape"])
        if dtype is None or begin != end or stop > len(buffer) or stop - begin != math.prod(shape) * dtype.itemsize:
            raise ValueError(f"{path}: tensor {name!r} has a bad dtype or offsets: {info}")
        data = torch.frombuffer(buffer, dtype=torch.uint8, count=stop - begin, offset=begin) if stop > begin else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = data.view(dtype).reshape(shape)
        end = stop
    if end != len(buffer):
        raise ValueError(f"{path}: the tensors do not cover the data ({end} of {len(buffer)} bytes)")
    return out


def safetensors_load_metadata(path: str) -> Dict[str, str]:
    """The `__metadata__` of a safetensors file ({} if it has none)."""
    with open(path, "rb") as f:
        return _read_header(f, path).get("__metadata__", {}) or {}


def safetensors_load_index(index_path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a model split into shards: every shard that the
    `*.safetensors.index.json` at `index_path` names in its `weight_map`, read
    from its directory, each name from the shard the map gives it."""
    with open(index_path) as f:
        weight_map = json.load(f)["weight_map"]
    root, out = os.path.dirname(index_path), {}
    for shard in sorted(set(weight_map.values())):
        tensors = safetensors_load_dict(os.path.join(root, shard))
        out.update({name: tensors[name] for name, where in weight_map.items() if where == shard})
    return out
