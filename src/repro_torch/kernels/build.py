"""Build the CUDA sources under ``repro_torch/csrc/`` and load them.

Each source is one shared library with a plain C interface, compiled by
nvcc for Hopper (``sm_90a``) into ``build/repro_torch/`` at the root of
the checkout and loaded with ``ctypes``.  The library's file name carries
a hash of its source and flags, so an edited source is never served from
a stale build.  ``build`` starts one nvcc per source, all at once.
A failed build raises; there is no fallback.  ``load`` is safe to call
from several threads (the async runtime's workers): one builds, the
others wait for it.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",   # registers, shared memory and spills, into the build log
)
# Every kernel source; ``name`` is the file stem under csrc/.
SOURCES = ("thompson_choose", "iou_matrix", "flash_attention", "flash_decode", "ssd_scan")

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build the CUDA kernels")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names=SOURCES) -> dict[str, dict]:
    """Compile ``names`` in parallel (one nvcc each).  Returns per source
    ``{"path", "seconds", "log"}``; ``log`` is nvcc's output, with
    ptxas' resource report.  Raises if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        # one name per process and thread: two builds of a source never share a file
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), out, tmp, time.perf_counter())
    result, failed = {}, []
    for name, (proc, out, tmp, t0) in procs.items():
        stdout, stderr = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        result[name] = {"path": str(out), "seconds": secs, "log": stdout + stderr}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if it is not there.
    Thread-safe: a library is built and loaded once, under a lock that
    only a miss takes."""
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
            lib = _loaded.get(name)
            if lib is None:
                path = library_path(name)
                if not path.exists():
                    build((name,))
                lib = ctypes.CDLL(str(path))
                _loaded[name] = lib
    return lib
