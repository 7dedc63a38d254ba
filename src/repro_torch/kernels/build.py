"""Build and load the hand-written CUDA kernels under ``src/repro_torch/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -lineinfo
         -shared -Xcompiler -fPIC -Xptxas -v

into ``build/kernels/<name>-<hash>.so`` at the repository root (a
git-ignored directory).  The hash covers the source, every shared header
``csrc/*.cuh`` it may include, and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.  ``-lineinfo``
changes no code (the registers and spills ``-Xptxas -v`` reports are the
same) and lets ``compute-sanitizer`` name the ``.cu`` line of an error
(:mod:`repro_torch.lint.sanitize`).  The library
is loaded with ``ctypes``; callers declare each function's ``argtypes``
(``c_void_p`` for pointers and the stream) through :func:`load_function`.

Each C entry point launches on the stream it is given, allocates nothing,
does not synchronise, and returns ``cudaGetLastError()``; :func:`check`
turns a nonzero code into an exception.  Nothing here runs at import time:
this module is imported on machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("scatter_score", "ell_gather", "bmp_scan", "splade_head",
           "flash_attention", "embedding_bag")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
# name -> the compiler's report (ptxas registers, shared memory, spills)
compiler_log: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every stale library in ``names``: one ``nvcc`` per source,
    all started together.  Raises with the compiler's output on failure."""
    stale = [n for n in names if not library_path(n).exists()]
    if not stale:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in stale:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        compiler_log[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def sass_count(name: str, opcode: str):
    """How many ``opcode`` instructions (e.g. ``HGMMA``, ``HMMA``) the built
    library ``name`` holds, from ``cuobjdump -sass``; None where the toolkit
    has no ``cuobjdump``."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(library_path(name))],
                         check=True, capture_output=True, text=True,
                         timeout=300).stdout
    # "/*0150*/  @P0 HGMMA.64x128x16.F32.BF16 R24, ... ;" -> "HGMMA"
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", out)
    return ops.count(opcode)


def load_function(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """``fn`` from library ``name`` (built if stale), returning int."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(library_path(name)))
    f = getattr(_libs[name], fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(name: str, err: int) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        msg = load_function(name, f"{name}_error_string", [ctypes.c_int])
        msg.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{name}: CUDA error {err}: {msg(err).decode()}"
        )


def score_dtype(name: str, qw: torch.Tensor, values: torch.Tensor):
    """The route a scoring kernel takes for query weights ``qw`` and index
    values ``values``: float32 or bfloat16, the same for both; anything
    else raises."""
    if qw.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: query weights of dtype {qw.dtype}; the "
                        "kernel has float32 and bfloat16 routes")
    if values.dtype != qw.dtype:
        raise TypeError(f"{name}: index values of dtype {values.dtype} "
                        f"with query weights of dtype {qw.dtype}")
    return qw.dtype


def expect(t: torch.Tensor, what: str, dtype, shape=None,
           device: torch.device | None = None,
           contiguous: bool = True) -> None:
    """Validate a kernel operand before its pointer reaches C: its dtype,
    shape and device where given, and its layout unless ``contiguous`` is
    False (an operand the kernel reads through its strides, which the
    caller checks)."""
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
