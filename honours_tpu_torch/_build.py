"""Build and bind the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc for sm_90a into its own shared library
with a plain C interface, loaded with ctypes.  The build runs at first
use (or through `build()`), one nvcc process per source, all started
together, into build/kernels/ beside the package; a library's file name
carries a hash of its sources, so an edited kernel is rebuilt.

Every C entry launches on the stream it is given and returns
cudaGetLastError(); `Kernel.__call__` raises on a non-zero code and
counts the launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = (
    "permute.cu", "rans_o1.cu", "rans_encode.cu", "svb16.cu", "rans_n4.cu",
    "segment.cu", "rice.cu", "huffdec.cu", "rangecoder.cu", "rccdf.cu",
    "huffbuild.cu", "bitpack.cu", "zsm.cu", "flats.cu", "hdrwalk.cu",
    "flac.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
)

_LIBS: dict[str, ctypes.CDLL] = {}
_ARG = {"p": ctypes.c_void_p, "l": ctypes.c_longlong}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build honours_tpu_torch's kernels")
    return nvcc


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for p in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns {source: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in SOURCES}
    procs = []
    for s in [s for s, p in paths.items() if not p.exists()]:
        tmp = paths[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for s, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{s}:\n{out}")
            continue
        os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _library(source: str) -> ctypes.CDLL:
    lib = _LIBS.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build()
        lib = _LIBS[source] = ctypes.CDLL(str(path))
        lib.htt_error_string.restype = ctypes.c_char_p
        lib.htt_error_string.argtypes = [ctypes.c_int]
    return lib


class Kernel:
    """One C entry of a kernel library, with its launch count.

    `signature` has one letter per argument: p = pointer (tensor
    data_ptr or stream handle), l = 64-bit integer."""

    def __init__(self, name: str, source: str, symbol: str, signature: str):
        self.name, self.source, self.symbol = name, source, symbol
        self.signature = signature
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            lib = _library(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [_ARG[c] for c in self.signature]
            fn.restype = ctypes.c_int
            self._fn, self._lib = fn, lib
        err = self._fn(*args)
        if err != 0:
            msg = self._lib.htt_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err}: {msg}")
        self.launches += 1


#: every kernel of the package, by name (chip_smoke.py reads the counts)
KERNELS: dict[str, Kernel] = {}


def kernel(name: str, source: str, symbol: str, signature: str) -> Kernel:
    k = KERNELS[name] = Kernel(name, source, symbol, signature)
    return k


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain route), False
    when every one lies on a CUDA device (the kernel route)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def check(t: torch.Tensor, name: str, dtypes, shape=None) -> None:
    """Raise unless `t` has one of `dtypes`, the given shape and is
    contiguous — what a kernel takes."""
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor is not contiguous")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
