"""The safetensors format, read and written without the ``safetensors``
package.

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor's name to its dtype, shape and ``data_offsets`` (begin, end)
relative to the first byte after the header, an optional
``__metadata__`` map of strings, then the tensors' bytes.

``load_safetensors`` maps each file copy-on-write and returns tensors
viewed on the mapping: nothing is read or copied until a caller touches
or moves a tensor, so a checkpoint costs host memory only as its pages
are read. ``save_safetensors`` writes one tensor at a time; a value may be
a ``Lazy`` tensor, made only when its bytes are written, so a writer of a
large checkpoint holds one tensor at a time.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
          "F64": torch.float64, "I8": torch.int8, "U8": torch.uint8,
          "I16": torch.int16, "I32": torch.int32, "I64": torch.int64,
          "BOOL": torch.bool}
NAMES = {dtype: name for name, dtype in DTYPES.items()}
HEADER_ALIGN = 8


@dataclasses.dataclass(frozen=True)
class Lazy:
    """A tensor that ``save_safetensors`` makes when it writes it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    make: Callable[[], torch.Tensor]


def read_header(path: str) -> Tuple[dict, int]:
    """(the JSON header, the offset of the first data byte) of one file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
    return header, 8 + n


def safetensors_files(path_or_dir: str) -> list:
    """A file as it is; a directory's ``*.safetensors`` in sorted order (its
    ``model.safetensors.index.json`` is not needed)."""
    if os.path.isdir(path_or_dir):
        return [os.path.join(path_or_dir, p) for p in sorted(os.listdir(path_or_dir))
                if p.endswith(".safetensors")]
    return [path_or_dir]


def _view(data: np.ndarray, dtype: torch.dtype, shape: Sequence[int]) -> torch.Tensor:
    """A tensor of ``dtype`` and ``shape`` on the bytes ``data`` (uint8)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    if data.ctypes.data % itemsize:
        data = data.copy()             # a misaligned tensor: its own aligned buffer
    return torch.from_numpy(data).view(dtype).reshape(tuple(shape))


def load_safetensors(path_or_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a .safetensors file, or of every one in a checkpoint
    directory, as CPU tensors on copy-on-write maps of the files."""
    out: Dict[str, torch.Tensor] = {}
    for path in safetensors_files(path_or_dir):
        header, start = read_header(path)
        size = os.path.getsize(path)
        mapped = (np.memmap(path, dtype=np.uint8, mode="c") if size > start
                  else np.zeros(0, np.uint8))
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {name!r} has dtype "
                                 f"{info['dtype']!r}, which is not supported "
                                 f"(supported: {', '.join(DTYPES)})")
            begin, end = info["data_offsets"]
            out[name] = _view(mapped[start + begin:start + end], dtype, info["shape"])
    return out


def _nbytes(shape: Sequence[int], dtype: torch.dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()


def save_safetensors(tensors: Mapping[str, Union[torch.Tensor, Lazy]], path: str,
                     metadata: Optional[Mapping[str, str]] = None) -> None:
    """Write ``tensors`` (name → tensor, on any device, or ``Lazy``) to one
    file: the header first, padded to 8 bytes, then each tensor's bytes in
    turn, the widest dtypes first so that every tensor is aligned to its
    element size. A ``Lazy`` value is made just before its bytes are
    written and dropped after."""
    items = sorted(tensors.items(), key=lambda kv: -torch.empty(
        (), dtype=kv[1].dtype).element_size())
    header, offset = {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in items:
        if t.dtype not in NAMES:
            raise ValueError(f"tensor {name!r}: dtype {t.dtype} cannot be saved")
        n = _nbytes(t.shape, t.dtype)
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % HEADER_ALIGN)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name, t in items:
            if isinstance(t, Lazy):
                t = t.make()
                if tuple(t.shape) != tuple(tensors[name].shape) or t.dtype != tensors[name].dtype:
                    raise ValueError(f"tensor {name!r} was made as {t.dtype} "
                                     f"{tuple(t.shape)}, not as declared")
            host = t.detach().contiguous().reshape(-1).cpu()
            f.write(memoryview(host.view(torch.uint8).numpy()))
            del t, host
