"""Build and load the port's CUDA kernels.

``csrc/*.cu`` (with the headers they include) compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
:mod:`ctypes`. Each source compiles in its own ``nvcc`` process, all
started together, and one more call links the objects. The build happens
at first use, into ``tpu_cc_manager_torch/_build/<digest>/``, where the
digest hashes the sources, their headers and the flags: an unchanged
checkout loads the library it built before, and any edit builds afresh.
The sources in the package are the only input.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Union

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("runtime.cu", "fleet_tick.cu", "fleet_plan.cu", "delta_scatter.cu",
           "probe.cu", "mesh_combine.cu")
#: headers the sources include; hashed with them
HEADERS = ("warp_runs.cuh",)
LIB_NAME = "libtpu_cc_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v"]

#: library loads since process start: ``hits`` found a finished build
#: for these sources, ``misses`` compiled one; ``seconds`` is the time the
#: last compile took and ``log`` its compiler output (ptxas register and
#: shared-memory lines included)
BUILD_STATS: Dict[str, Union[int, float, str]] = {
    "hits": 0, "misses": 0, "seconds": 0.0, "log": ""}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the port's CUDA kernels cannot be built")


def source_digest() -> str:
    h = hashlib.sha256()
    for flag in COMPILE_FLAGS:
        h.update(flag.encode() + b"\0")
    for name in SOURCES + HEADERS:
        h.update(name.encode() + b"\0")
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / source_digest() / LIB_NAME


def _compile(target: Path) -> None:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        t0 = time.monotonic()
        procs = []
        for name in SOURCES:
            obj = work / (name + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(CSRC_DIR / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs: List[str] = []
        failed = []
        for name, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
             *(str(obj) for _name, obj, _proc in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        target.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, target)
        BUILD_STATS["seconds"] = time.monotonic() - t0
        BUILD_STATS["log"] = "\n".join(logs)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tcc_fleet_tick.argtypes = [p, i, p, i, i, i, i, p, p, p, p, p]
    lib.tcc_fleet_tick.restype = i
    lib.tcc_fleet_tick_partial.argtypes = [p, i, p, i, i, i, i, p, p, p, p]
    lib.tcc_fleet_tick_partial.restype = i
    i64 = ctypes.c_longlong
    lib.tcc_fleet_plan.argtypes = [p, i, i, i64, p, p, p, p, p]
    lib.tcc_fleet_plan.restype = i
    lib.tcc_delta_scatter.argtypes = [p, i, i, i64, i64, p, p, i, p]
    lib.tcc_delta_scatter.restype = i
    lib.tcc_mesh_combine.argtypes = [p, p, i, i, i, p, p, p]
    lib.tcc_mesh_combine.restype = i
    lib.tcc_mesh_sum.argtypes = [p, i, i, p, p]
    lib.tcc_mesh_sum.restype = i
    lib.tcc_probe_add_one.argtypes = [p, p, ctypes.c_int64, p]
    lib.tcc_probe_add_one.restype = i
    lib.tcc_error_string.argtypes = [i]
    lib.tcc_error_string.restype = ctypes.c_char_p
    lib.tcc_memory_bytes_per_s.argtypes = [i]
    lib.tcc_memory_bytes_per_s.restype = ctypes.c_double
    lib.tcc_empty_kernel.argtypes = [p]
    lib.tcc_empty_kernel.restype = i


def library() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per
    process. Raises when ``nvcc`` is missing or refuses a source."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path = library_path()
            if path.is_file():
                BUILD_STATS["hits"] = int(BUILD_STATS["hits"]) + 1
            else:
                _compile(path)
                BUILD_STATS["misses"] = int(BUILD_STATS["misses"]) + 1
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if rc != 0:
        text = library().tcc_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({text})")
