"""Build the port's CUDA kernels: every `quanto_tpu_torch/csrc/*.cu` into one
shared library with a plain C interface, loaded with `ctypes`.

Each source is compiled by its own `nvcc -c` for sm_90a, all started
together, and the objects are linked into
`quanto_tpu_torch/build/libquanto_kernels_<hash>.so` (gitignored). The hash
covers every source and the flags, so an edit to any source rebuilds and an
unchanged tree loads the library it already has. The build runs at first use,
never at import: a host without `nvcc` imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ["build", "kernel"]

_PKG = Path(__file__).resolve().parents[2]
_CSRC = _PKG / "csrc"
_BUILD_DIR = _PKG / "build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
_FNS: dict = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def _sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def build() -> dict:
    """Compile every `csrc/*.cu` (once per content of the sources) and load
    the library. Returns {"path", "sources", "seconds", "log"}: `seconds` and
    the compilers' `-Xptxas -v` reports `log` are those of this call's build,
    0.0 and "" when the library was already built."""
    global _LIB
    sources = _sources()
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    digest = h.hexdigest()[:16]
    path = _BUILD_DIR / f"libquanto_kernels_{digest}.so"
    seconds, log = 0.0, ""
    if not path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        tag = f"{digest}.{os.getpid()}"
        objs = [_BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        t0 = time.perf_counter()
        procs = [
            subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            log += f"== {src.name}\n{out}"
            if proc.returncode != 0:
                failed.append(src.name)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        if not failed:
            link = subprocess.run(
                [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True,
            )
            log += link.stdout + link.stderr
            if link.returncode != 0:
                failed.append("link")
        for obj in objs:
            obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        os.replace(tmp, path)
    if _LIB is None:
        _LIB = ctypes.CDLL(str(path))
    return {"path": str(path), "sources": [s.name for s in sources], "seconds": seconds, "log": log}


def kernel(name: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The library's C entry point `name` (building the library at first
    use), with its argument types set; it returns a cudaError_t as int."""
    fn = _FNS.get(name)
    if fn is None:
        if _LIB is None:
            build()
        fn = getattr(_LIB, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn
