"""Builds the CUDA kernels under ``egm_unet_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` compiles, with ``nvcc`` for ``sm_90a``, into its own
shared library with a plain C interface; the wrappers load it with ``ctypes``.
Nothing is built when the package is imported: the first launch builds its
kernel, and ``build_all`` builds every kernel at once, one ``nvcc`` process
per source, all started together.

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
KERNELS = ("conv3x3", "conv3x3_pair", "csa_attention", "eafe_edge", "mca_fused",
           "mca_gates", "up_concat_conv", "upsample2x")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


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


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
