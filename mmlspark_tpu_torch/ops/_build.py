"""Build-at-first-use for the port's CUDA sources.

Each `csrc/<name>.cu` (with the `csrc/*.cuh` headers it includes) is
compiled by `nvcc` for `sm_90a` into a shared library with a plain C
interface under `build/torch_kernels/` of the checkout, and loaded with
`ctypes`. The library's file name carries a hash of the sources and the
flags, so an edited source or header never loads a stale build.

Nothing here runs at import time: the CPU tests import every module, and
`nvcc` is only called when a kernel is first asked for on a CUDA tensor
(or by `chip_smoke.py`'s build phase).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}   # name -> ctypes.CDLL


def _target(name: str) -> Path:
    # the source and every header beside it
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(name: str) -> str | None:
    """Compile `csrc/<name>.cu` unless a current build exists. Returns
    nvcc's output (the ptxas register/shared-memory report), or None when
    there was nothing to build; raises if nvcc fails."""
    out = _target(name)
    if out.exists():
        return None
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on the machine with the card")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # written aside and renamed, so that a process loading the library
    # while another builds it never sees a partial file
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
