"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exports a plain C interface.  It is compiled with
nvcc for Hopper (`sm_90a`) into its own shared library under
`csrc/build/` at first use, and loaded with ctypes.  A library's file name
carries a hash of its source, the shared headers (`csrc/*.cuh`) and the
flags, so an edited source or header is rebuilt.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"
KERNELS = ("msda", "flash_attn", "dcn", "int8_gemm", "flash_attn_int8", "gather_probe",
           "dcn_fused")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    text = (CSRC / f"{name}.cu").read_bytes()
    # a source that includes another source (dcn_fused_split.cu) hashes it too
    text += b"".join((CSRC / inc.decode()).read_bytes()
                     for inc in re.findall(rb'#include "(\w+\.cu)"', text))
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = KERNELS, verbose: bool = False,
          force: bool = False) -> Dict[str, str]:
    """Compile every named kernel whose library is missing (with `force`,
    every named kernel): one nvcc per source, all started together.  Returns
    nvcc's output per kernel built (with `verbose`, ptxas' register and spill
    report).  Raises on any failed compile."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists() and not force:
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
