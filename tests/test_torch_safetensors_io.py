"""The port's safetensors reader and writer against quanto_tpu's.

For the same tensors (made from a seed with numpy; bfloat16 and float8 with
ml_dtypes on the JAX side, bit for bit the same tensors on the port's) and
metadata, `quanto_tpu_torch.utils.safetensors_io.save_file` writes the JAX
writer's bytes, for every dtype tag; each package reads the other's file bit
for bit. `save_sharded` writes the same shards and index, removes the same
stale files, and `LazySafetensors` gives the same keys and tensors.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from quanto_tpu.utils import safetensors_io as jax_io
from quanto_tpu_torch.serialization import numpy_to_torch
from quanto_tpu_torch.utils import safetensors_io as io

# Every tag of `_ST_TO_NP`, and e4m3fnuz, which both writers tag F8_E4M3.
DTYPES = {
    "BOOL": np.bool_,
    "I8": np.int8,
    "U8": np.uint8,
    "I16": np.int16,
    "U16": np.uint16,
    "I32": np.int32,
    "U32": np.uint32,
    "I64": np.int64,
    "U64": np.uint64,
    "F16": np.float16,
    "BF16": ml_dtypes.bfloat16,
    "F32": np.float32,
    "F64": np.float64,
    "F8_E4M3": ml_dtypes.float8_e4m3fn,
    "F8_E5M2": ml_dtypes.float8_e5m2,
    "F8_E4M3-fnuz": ml_dtypes.float8_e4m3fnuz,
}


def array(dtype, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt == np.bool_:
        return rng.integers(0, 2, shape).astype(np.bool_)
    if dt.kind in "iu":
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)
    return np.asarray(rng.standard_normal(shape) * 4).astype(dt)


def to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.dtype(ml_dtypes.float8_e4m3fnuz):
        return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fnuz)
    return numpy_to_torch(a.copy())


def raw(t) -> bytes:
    """A tensor's or array's bytes."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def tensors_for(tag: str, seed: int = 0) -> dict:
    """A [3, 5] tensor, a 0-d one and an empty one of the dtype."""
    dt = DTYPES[tag]
    return {"w": array(dt, (3, 5), seed), "s": array(dt, (), seed + 1), "e": array(dt, (0, 4), seed + 2)}


@pytest.fixture(autouse=True)
def jax_plain_reader(monkeypatch):
    """JAX reads safetensors here through its plain reader. Its native mmap
    reader (`quanto_tpu/utils/safetensors_io.py:_try_mmap`) unmaps the file
    right after `jnp.array(view, copy=True)`, whose host-to-device transfer
    may still be reading the view: under load that crashed a test worker
    (a segmentation fault in JAX's `from_pretrained`). Both readers give the
    same bytes."""
    monkeypatch.setattr(jax_io, "_try_mmap", lambda path: None)

@pytest.mark.parametrize("tag", list(DTYPES))
def test_save_file_bytes_and_reads_match_jax(tmp_path, tag):
    arrays = tensors_for(tag)
    meta = {"format": "pt", "note": tag}
    jax_path, port_path = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jax_io.save_file(arrays, str(jax_path), metadata=meta)
    io.save_file({k: to_torch(v) for k, v in arrays.items()}, str(port_path), metadata=meta)
    assert read(port_path) == read(jax_path)
    assert io.safe_open_header(str(port_path)) == jax_io.safe_open_header(str(jax_path))
    want_tag = tag.split("-")[0]
    assert {v["dtype"] for k, v in io.safe_open_header(str(port_path)).items() if k != "__metadata__"} == {want_tag}

    # Both writers store the 0-d tensor as [1] (the JAX writer's
    # `np.ascontiguousarray`), so both readers give it back as [1]. JAX reads
    # the port's file as it reads its own: into `jnp` arrays, which hold
    # 64-bit tags in 32 bits without x64.
    ported = io.load_file(str(jax_path))  # the JAX file in the port
    assert list(ported) == list(arrays)
    back = jax_io.load_file(str(port_path))  # the port's file in JAX
    own = jax_io.load_file(str(jax_path))
    for k, a in arrays.items():
        shape = a.shape or (1,)
        assert tuple(ported[k].shape) == shape and raw(ported[k]) == raw(a)
        assert back[k].shape == shape and back[k].dtype == own[k].dtype and raw(back[k]) == raw(own[k])


def test_load_file_onto_a_dtype_and_lazy_lookups(tmp_path):
    arrays = {tag: array(DTYPES[tag], (4, 6), i) for i, tag in enumerate(("F32", "BF16", "I8", "F8_E4M3"))}
    path = str(tmp_path / "m.safetensors")
    jax_io.save_file(arrays, path)
    with io.LazySafetensors.from_files([path]) as lazy:
        assert set(lazy.keys()) == set(arrays) and len(lazy) == 4 and "BF16" in lazy
        for k, a in arrays.items():
            assert raw(lazy[k]) == raw(a)
        as_f32 = lazy.get("BF16", dtype=torch.float32)
        assert as_f32.dtype == torch.float32
        np.testing.assert_array_equal(as_f32.numpy(), np.asarray(arrays["BF16"], np.float32))


@pytest.mark.parametrize("max_shard_size", ["1KB", 2500, "100MB"])
def test_save_sharded_and_lazy_match_jax(tmp_path, max_shard_size):
    arrays = {f"layers.{i}.w": array(DTYPES[t], (16, 24), i) for i, t in enumerate(["F32", "BF16", "U8", "I8", "F32"])}
    arrays["norm"] = array(np.float32, (24,), 9)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    jax_io.save_sharded(arrays, str(jax_dir), max_shard_size)
    io.save_sharded({k: to_torch(v) for k, v in arrays.items()}, str(port_dir), max_shard_size)
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names
    assert len(names) == (1 if max_shard_size == "100MB" else len(names))
    for name in names:
        assert read(port_dir / name) == read(jax_dir / name), name

    files = sorted(str(port_dir / n) for n in names if n.endswith(".safetensors"))
    jax_lazy = jax_io.LazySafetensors.from_files(files)
    with io.LazySafetensors.from_files(files) as lazy:
        assert list(lazy.keys()) == list(jax_lazy.keys())
        for k in arrays:
            assert raw(lazy[k]) == raw(jax_lazy[k]) == raw(arrays[k])


def test_save_sharded_removes_stale_files_as_jax(tmp_path):
    """Shards, then one file, then fewer shards: each package leaves the same
    files after each save."""
    arrays = {f"t{i}": array(np.float32, (64, 8), i) for i in range(6)}
    listings = {}
    for who, save, conv in (("jax", jax_io.save_sharded, lambda a: a), ("port", io.save_sharded, to_torch)):
        d = tmp_path / who
        d.mkdir()
        seen = []
        for size, keys in (("4KB", arrays), ("1MB", arrays), (4096, dict(list(arrays.items())[:3]))):
            save({k: conv(v) for k, v in keys.items()}, str(d), size)
            seen.append(sorted(os.listdir(d)))
        listings[who] = seen
    assert listings["port"] == listings["jax"]
    assert listings["port"][1] == ["model.safetensors"]
    assert "model.safetensors.index.json" in listings["port"][0] and "model.safetensors" not in listings["port"][2]


def test_save_file_refuses_an_unknown_dtype(tmp_path):
    with pytest.raises(ValueError, match="Unsupported dtype"):
        io.save_file({"c": torch.zeros(2, dtype=torch.complex64)}, str(tmp_path / "c.safetensors"))
