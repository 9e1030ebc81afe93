"""Native (C++) host components, built with ``g++`` at first use and bound
with ``ctypes``.

``load_library(name)`` compiles ``egm_unet_torch/native/<name>.cpp`` with
``g++ -O2 -shared -fPIC`` into ``egm_unet_torch/_build/`` (or
``$EGM_TORCH_BUILD_DIR``, the CUDA kernels' build directory) under a name
that hashes the source and flags, and returns the loaded library; it raises
when the compiler is missing or fails.  Each build writes a temporary file
of its own and renames it into place, so processes and threads that build
the same library at once do not see each other's half-written output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

from egm_unet_torch.ops.cuda.build import build_dir

NATIVE_DIR = Path(__file__).resolve().parent
CXX_FLAGS = ["-O2", "-shared", "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update((NATIVE_DIR / f"{name}.cpp").read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``<name>.cpp`` unless its library exists; returns its path."""
    out = library_path(name)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the native {name!r} library is built "
                           "with it at first use")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"),
                          "-o", str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {name}.cpp (exit {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The native library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS.setdefault(name, ctypes.CDLL(str(build_library(name))))
    return lib
