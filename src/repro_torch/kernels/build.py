"""Build and load the port's CUDA kernels (one shared library, plain C ABI).

The sources under ``csrc/`` are compiled for Hopper (``sm_90a``) with
``nvcc``, one process per source, all started together, and linked into
``libreprokernels.so`` under ``<repo>/build/kernels/<hash>/``, where the
hash covers the sources and the flags.  The library is loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds.  Building happens at the first kernel launch (or an explicit
:func:`build` call), never at import, so the package imports on a machine
without ``nvcc`` or a card.  Processes started together (a fleet's socket
workers) build once: the check, the build and the rename run under an
exclusive ``flock`` on ``build/kernels/<hash>.lock``, so the others wait and
then load the finished library, and none loads a directory another is
replacing.

Every C entry point takes the CUDA stream as its last argument and returns
``cudaGetLastError()`` (or, where a TMA tensor map cannot be encoded, a
status ``common.cu`` names); :func:`check` raises on a non-zero status.
"""

from __future__ import annotations

import ctypes
import dataclasses
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("common.cu", "int8_gemm.cu", "decode_attention.cu",
           "flash_attention.cu", "paged_chunk_attention.cu", "ecc_decode.cu",
           "w4a16_gemv.cu", "ssd_scan.cu", "grouped_gemm.cu",
           "mla_decode_attention.cu")
# included by the tensor-core sources; attention_tile.cuh holds the
# per-block arithmetic B3 and the paged chunk kernel share
HEADERS = ("hopper.cuh", "attention_tile.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libreprokernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures of the entry points (pointers and the stream as void*)
SIGNATURES = {
    "repro_int8_gemv": [_P, _P, _P, _I, _I, _I, _P],
    "repro_int8_gemv_dp4a": [_P, _P, _P, _I, _I, _I, _P],
    "repro_int8_gemm": [_P, _P, _P, _I, _I, _I, _P],
    "repro_int8_gemm_tc": [_P, _P, _P, _I, _I, _I, _P],
    "repro_paged_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                     _P],
    "repro_paged_chunk_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _I, _I, _I, _I, _I, _F, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              ctypes.POINTER(ctypes.c_longlong), _F, _I,
                              _P],
    "repro_ecc_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_w4a16_gemv": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_w4a16_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "repro_ssd_intra_chunk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, ctypes.POINTER(ctypes.c_longlong),
                              _P],
    "repro_grouped_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_mla_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _I, _I, _I, _I, _I, _I, _I, _I, _F, _P],
}


@dataclasses.dataclass
class Build:
    path: Path
    log: str        # nvcc's output (the -Xptxas -v resource summary)
    built: bool     # False when an earlier build of the same hash was reused


_LIB: ctypes.CDLL | None = None
_BUILD: Build | None = None


def repo_root() -> Path:
    return Path(__file__).resolve().parents[3]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Build:
    """Compile every source in parallel and link the shared library; a
    library already built from the same sources and flags is reused.  Runs
    under the hash's lock file, so concurrent processes build once."""
    global _BUILD
    digest = _digest()
    root = repo_root() / "build" / "kernels"
    root.mkdir(parents=True, exist_ok=True)
    with open(root / f"{digest}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        _BUILD = _build_locked(root / digest)
    return _BUILD


def _build_locked(out_dir: Path) -> Build:
    lib = out_dir / LIB_NAME
    log_file = out_dir / "nvcc.log"
    if lib.exists():
        return Build(lib, log_file.read_text() if log_file.exists() else "",
                     built=False)
    nvcc = nvcc_path()
    work = Path(tempfile.mkdtemp(dir=out_dir.parent, prefix="tmp-"))
    procs = []
    for name in SOURCES:
        obj = work / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, _obj, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    if failed:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(work / LIB_NAME),
         *[str(obj) for _n, obj, _p in procs], "-lcudart"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        shutil.rmtree(work, ignore_errors=True)
        raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
    (work / "nvcc.log").write_text(log)
    if out_dir.exists():  # a build cut short before its library: replace it
        shutil.rmtree(out_dir)
    os.replace(work, out_dir)
    return Build(lib, log, built=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        b = _BUILD if _BUILD is not None else build()
        lib = ctypes.CDLL(str(b.path))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(status: int, name: str) -> None:
    if status != 0:
        msg = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{name} failed to launch: {msg} ({status})")


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a raw pointer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
