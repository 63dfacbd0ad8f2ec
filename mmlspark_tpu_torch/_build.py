"""Build and load the port's CUDA kernels and its host libraries.

Each CUDA source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes`` at first use; the host binning source (``bins.cpp``) is
compiled the same way by the host C++ compiler with OpenMP, as is the
host image library (``image.cpp``: resize and unroll). The image codecs
(``imgcodec.cpp``) link libjpeg and libpng, whose headers a machine may
lack, so they build only when a decode first needs them, never in
``build_all``'s default set. Libraries
land in ``build/mmlspark_tpu_torch/`` at the root of the checkout, named
by a hash of their source, the headers under ``csrc/`` (CUDA libraries)
and the flags, so an edited source or header rebuilds and an unchanged
one is reused; the compiler's output is kept beside each library. All
missing sources build in parallel, one compiler process each.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
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

# host library name -> source under csrc/, built by the host compiler
HOST_SOURCES: Dict[str, str] = {"bins": "bins.cpp", "image": "image.cpp"}

HOST_FLAGS = ["-std=c++17", "-O3", "-fopenmp", "-shared", "-fPIC"]

# host libraries built only on first use (not by build_all() without
# names): library name -> (source under csrc/, the libraries it links)
ON_DEMAND_SOURCES: Dict[str, Tuple[str, Tuple[str, ...]]] = {
    "imgcodec": ("imgcodec.cpp", ("-ljpeg", "-lpng"))}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


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


def _host_cxx() -> str:
    for cxx in ("g++", "c++"):
        found = shutil.which(cxx)
        if found:
            return found
    raise RuntimeError(
        "no host C++ compiler (g++ / c++) found: the port's host libraries "
        "are built from csrc/*.cpp")


def source_of(name: str) -> str:
    """The source file under ``csrc/`` of library ``name``."""
    if name in ON_DEMAND_SOURCES:
        return ON_DEMAND_SOURCES[name][0]
    return SOURCES.get(name) or HOST_SOURCES[name]


def _link_flags(name: str) -> Tuple[str, ...]:
    return ON_DEMAND_SOURCES[name][1] if name in ON_DEMAND_SOURCES else ()


def library_path(name: str) -> Path:
    """Where library ``name`` lives: named by a hash of its source, for
    a CUDA library every header under ``csrc/`` (sorted by name), and
    the flags, so an edited header rebuilds the CUDA libraries too."""
    h = hashlib.sha256((CSRC / source_of(name)).read_bytes())
    if name in SOURCES:
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(HOST_FLAGS + list(_link_flags(name))).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory and
    spills of each kernel) of kernel ``name``'s library, kept beside it
    when it was built; "" if it is not built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Optional[Iterable[str]] = None
              ) -> Dict[str, Tuple[float, str]]:
    """Compile every requested library (by default every CUDA kernel and
    the ``HOST_SOURCES`` libraries) whose file is missing, all in parallel. Returns
    {name: (seconds, compiler log)} for the libraries it built; raises
    RuntimeError with the compiler output if any build fails."""
    names = ([*SOURCES, *HOST_SOURCES] if names is None else list(names))
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        if n in SOURCES:
            cmd = [_nvcc(), *NVCC_FLAGS]
        else:
            cmd = [_host_cxx(), *HOST_FLAGS]
        cmd += ["-o", str(tmp), str(CSRC / source_of(n)), *_link_flags(n)]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    done: Dict[str, Tuple[float, str]] = {}
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{source_of(n)}: compiler exit "
                          f"{proc.returncode}\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
        done[n] = (secs, log)
    if errors:
        raise RuntimeError("library build failed:\n" + "\n".join(errors))
    return done


def adopt(name: str, path: Path) -> bool:
    """Load library ``name`` from ``path`` (a copy that an AOT artifact
    carries, ``serving/aot.py``) when its file name is the one
    ``library_path`` gives for this tree's sources; then ``load`` returns
    it without a build. False, and nothing loaded, when the hash differs
    or the library is loaded already."""
    path = Path(path)
    if path.name != library_path(name).name or not path.exists():
        return False
    with _LOAD_LOCK:
        if name in _LIBS:
            return False
        _LIBS[name] = ctypes.CDLL(str(path))
    return True


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:     # one build per process, whatever the thread
            lib = _LIBS.get(name)
            if lib is None:
                build_all([name])
                lib = ctypes.CDLL(str(library_path(name)))
                _LIBS[name] = lib
    return lib
