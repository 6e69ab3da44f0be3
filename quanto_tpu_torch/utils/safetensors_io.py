"""Minimal safetensors reader and writer.

PyTorch counterpart of `quanto_tpu/utils/safetensors_io.py`. The format is
written directly, as the JAX module writes it: an 8-byte little-endian header
length, a compact JSON header mapping tensor names to `{dtype, shape,
data_offsets}` padded with spaces to 8 bytes, then the raw bytes of each
tensor in the order given. For the same tensors and metadata the file is
byte for byte the JAX writer's, so a checkpoint saved by either package loads
in the other. It needs neither the `safetensors` package nor `ml_dtypes`:
bfloat16 and float8 tensors are written and read through uint8 views.

Reads go through `mmap` and `torch.frombuffer`; every tensor handed out is a
copy (on the host, or on the device it is asked for), made before the
mapping closes.
"""

from __future__ import annotations

import json
import mmap
import os
import re
import struct
from typing import Dict, Iterable, Optional, Union

import torch


__all__ = ["save_file", "load_file", "safe_open_header", "LazySafetensors", "save_sharded"]


# safetensors dtype tag <-> torch dtype (`_ST_TO_NP`, `safetensors_io.py:27-46`).
_ST_TO_TORCH = {
    "BOOL": torch.bool,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "U16": torch.uint16,
    "I32": torch.int32,
    "U32": torch.uint32,
    "I64": torch.int64,
    "U64": torch.uint64,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F32": torch.float32,
    "F64": torch.float64,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
}
_TORCH_TO_ST = {v: k for k, v in _ST_TO_TORCH.items()}
# fnuz has the same byte width; tagged E4M3 as the JAX writer tags it.
_TORCH_TO_ST[torch.float8_e4m3fnuz] = "F8_E4M3"


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes as a contiguous uint8 tensor on the host."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def save_file(
    tensors: Dict[str, torch.Tensor], path: str, metadata: Optional[Dict[str, str]] = None
) -> None:
    """Write `tensors` (on any device) to `path`, in their order, moving one
    tensor at a time to the host."""
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        tag = _TORCH_TO_ST.get(t.dtype)
        if tag is None:
            raise ValueError(f"Unsupported dtype for safetensors: {t.dtype} (tensor {name!r})")
        # A 0-d tensor is written as [1], as the JAX writer writes it (its
        # `np.ascontiguousarray` returns at least one dimension).
        shape = list(t.shape) or [1]
        header[name] = {"dtype": tag, "shape": shape, "data_offsets": [offset, offset + _nbytes(t)]}
        offset += _nbytes(t)
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    header_bytes += b" " * ((-len(header_bytes)) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for t in tensors.values():
            f.write(_host_bytes(t).numpy().data)


def safe_open_header(path: str) -> Dict[str, dict]:
    """The parsed JSON header (tensor name -> {dtype, shape, data_offsets})."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(header_len).decode("utf-8"))


class _MappedFile:
    """One safetensors file mapped into memory (copy-on-write, so that
    `torch.frombuffer` gets a writable buffer; nothing is ever written)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            self.header = json.loads(f.read(header_len).decode("utf-8"))
            self.base = 8 + header_len
            size = os.fstat(f.fileno()).st_size
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > self.base else None

    def get(self, name: str, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """A copy of tensor `name` on `device` (the host by default), cast to
        `dtype` when given (on the host, before the copy to the device)."""
        info = self.header[name]
        st_dtype = _ST_TO_TORCH[info["dtype"]]
        start, end = info["data_offsets"]
        if end == start:
            out = torch.empty(info["shape"], dtype=st_dtype)
        else:
            view = torch.frombuffer(self._mm, dtype=torch.uint8, count=end - start, offset=self.base + start)
            out = view.view(st_dtype).reshape(info["shape"])
        if dtype is not None and dtype != st_dtype:
            out = out.to(dtype)
        elif device is None or torch.device(device).type == "cpu":
            out = out.clone()
        return out if device is None else out.to(device)

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None


def load_file(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the host (`LazySafetensors.get`
    reads one onto a device)."""
    mf = _MappedFile(path)
    try:
        return {name: mf.get(name) for name in mf.header if name != "__metadata__"}
    finally:
        mf.close()


class LazySafetensors:
    """Lazy per-tensor access over one or many safetensors shards (the JAX
    module's `LazySafetensors`, `safetensors_io.py:148`): a tensor is read
    from its mapped file when asked for, so that loading a sharded checkpoint
    never holds the whole file set in memory. `get(name, device, dtype)`
    reads straight onto a device; `close()` (or leaving a `with` block)
    unmaps the files."""

    def __init__(self, paths: Dict[str, str]):
        self._paths = paths  # tensor name -> file path
        self._files: Dict[str, _MappedFile] = {}

    @classmethod
    def from_files(cls, files: Iterable[str]) -> "LazySafetensors":
        paths: Dict[str, str] = {}
        for fp in files:
            for name in safe_open_header(fp):
                if name != "__metadata__":
                    paths[name] = fp
        return cls(paths)

    def keys(self):
        return self._paths.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._paths

    def __len__(self) -> int:
        return len(self._paths)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.get(name)

    def get(self, name: str, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        fp = self._paths[name]
        if fp not in self._files:
            self._files[fp] = _MappedFile(fp)
        return self._files[fp].get(name, device, dtype)

    def close(self) -> None:
        for mf in self._files.values():
            mf.close()
        self._files.clear()

    def __enter__(self) -> "LazySafetensors":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


_SIZE_UNITS = {"KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}


def _parse_size(size: Union[int, str]) -> int:
    if isinstance(size, int):
        return size
    s = str(size).strip().upper()
    for unit, mult in _SIZE_UNITS.items():
        if s.endswith(unit):
            return int(float(s[: -len(unit)]) * mult)
    return int(s)


def save_sharded(tensors: Dict[str, torch.Tensor], directory: str, max_shard_size: Union[int, str] = "5GB") -> None:
    """Write `tensors` as one `model.safetensors`, or, above
    `max_shard_size`, as transformers-convention shards
    (`model-00001-of-0000N.safetensors` + `model.safetensors.index.json`,
    whose `weight_map` names each tensor's shard), as the JAX module's
    `save_sharded` (`safetensors_io.py:217`) writes them, byte for byte. Stale
    files of the other form, and shards of an earlier save, are removed, so
    that a directory never holds both."""
    limit = _parse_size(max_shard_size)
    single_path = os.path.join(directory, "model.safetensors")
    index_path = single_path + ".index.json"
    shard_re = re.compile(r"^model-\d{5}-of-\d{5}\.safetensors$")

    def remove_stale_shards(keep=()):
        for name in os.listdir(directory):
            if shard_re.match(name) and name not in keep:
                os.remove(os.path.join(directory, name))

    sizes = {name: _nbytes(t) for name, t in tensors.items()}
    if sum(sizes.values()) <= limit:
        save_file(tensors, single_path)
        if os.path.exists(index_path):
            os.remove(index_path)
        remove_stale_shards()
        return
    shards = [[]]
    shard_bytes = 0
    for name in tensors:
        if shards[-1] and shard_bytes + sizes[name] > limit:
            shards.append([])
            shard_bytes = 0
        shards[-1].append(name)
        shard_bytes += sizes[name]
    weight_map = {}
    for i, names in enumerate(shards, start=1):
        fname = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        save_file({k: tensors[k] for k in names}, os.path.join(directory, fname))
        weight_map.update((k, fname) for k in names)
    with open(index_path, "w") as f:
        json.dump({"metadata": {"total_size": sum(sizes.values())}, "weight_map": weight_map}, f, indent=2)
    if os.path.exists(single_path):
        os.remove(single_path)
    remove_stale_shards(keep=set(weight_map.values()))
