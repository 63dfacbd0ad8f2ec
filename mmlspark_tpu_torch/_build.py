"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes`` at first use. Libraries land in ``build/mmlspark_tpu_torch/``
at the root of the checkout, named by a hash of their source, the
headers under ``csrc/`` and the flags, so an edited source or header
rebuilds and an unchanged one is reused; the compiler's output is kept
beside each library. All
missing sources build in parallel, one ``nvcc`` process each.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "mmlspark_tpu_torch"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {"hist": "hist.cu", "flash_fwd": "flash_fwd.cu",
                           "flash_bwd": "flash_bwd.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ on "
        "a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: named by a hash of its
    source, every header under ``csrc/`` (sorted by name) and the flags,
    so an edited header rebuilds the libraries too."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) of kernel ``name``'s library, kept beside it
    when it was built; "" if it is not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None
              ) -> Dict[str, Tuple[float, str]]:
    """Compile every requested kernel whose library is missing, all in
    parallel. Returns {name: (seconds, compiler log)} for the kernels
    it built; raises RuntimeError with the compiler output if any
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done: Dict[str, Tuple[float, str]] = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}: nvcc exit {proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[n] = (secs, log)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
