"""Builds the CUDA kernels under ``egm_unet_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` (``KERNELS``: every top-level source) compiles, with
``nvcc`` for ``sm_90a``, into its own shared library with a plain C
interface.  Nothing is built when the package is imported: the first launch
builds its kernel, and ``build_all`` builds every kernel at once, one
``nvcc`` process per source, all started together.

A wrapper declares each C entry point it calls as an ``Entry``; calling the
entry configures the ``ctypes`` function once, launches, checks the error and
counts the launch under the kernel's name in ``LAUNCHES``.

Libraries go to ``egm_unet_torch/_build`` (or ``$EGM_TORCH_BUILD_DIR``) under
a name that hashes the sources and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
KERNELS = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel -> launches since the last reset, one key an ``Entry``
LAUNCHES: Dict[str, int] = {}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}


def build_dir() -> Path:
    return Path(os.environ.get("EGM_TORCH_BUILD_DIR", PKG_DIR / "_build"))


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every missing kernel library, in parallel.  Returns per kernel
    ``{"seconds", "cached", "ptxas"}``; raises if any compile fails."""
    names = list(KERNELS if names is None else names)
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs, info = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            info[name] = {"seconds": 0.0, "cached": True, "ptxas": ""}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        info[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                      "ptxas": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return info


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


class Entry:
    """The C entry point ``symbol`` of ``csrc/<source>.cu``, whose launches
    count as ``kernel``.  ``signature`` spells its parameters, one letter
    each: ``p`` a pointer, ``i`` an int, ``l`` a long long; it returns a
    ``cudaError_t``."""

    def __init__(self, kernel: str, source: str, symbol: str, signature: str):
        self.kernel, self.source, self.symbol = kernel, source, symbol
        self.argtypes = [_CTYPES[c] for c in signature]
        self._fn = None
        LAUNCHES[kernel] = 0

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.kernel}: CUDA launch failed with cudaError {err}")
        LAUNCHES[self.kernel] += 1
