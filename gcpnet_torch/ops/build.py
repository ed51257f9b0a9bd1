"""Build the port's CUDA kernels and load them through ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``gcpnet_torch/build/`` (listed in ``.gitignore``).  Only sources in the
repository are used.  Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, where only the CPU paths run.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

# C entry points: library -> {function: argtypes}; every launching one
# returns the cudaGetLastError() code after its launches (an int), the
# others the type RESTYPES gives.
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SIGNATURES = {
    "segment_sorted": {
        "gcp_segment_sum_sorted": [_P, _P, _P, _LL, _I, _I, _I, _P],
    },
    "edge_map_tc": {
        "gcp_edge_map_tc": [_P, _P, _P, _P, _I, _P, _LL, _I, _P],
        "gcp_edge_map_tc_images": [_P, _P, _I, _P, _I, _P],
        "gcp_edge_map_tc_image_bytes": [_P, _I, _I],
        "gcp_edge_map_tc_layout": [_P, _I, _I, _P],
    },
    "edge_map_bwd_tc": {
        "gcp_edge_map_bwd_tc": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _LL, _LL, _LL, _I, _I, _P],
        "gcp_edge_map_bwd_tc_image_bytes": [_P, _I, _I],
        "gcp_edge_map_bwd_tc_tile": [_P, _I, _I, _P],
    },
}
# K3's kernels for stacks with selu, gelu, sigmoid or tanh: the same source
# and entry points, built apart (csrc/edge_map_bwd_tc_all.cu)
SIGNATURES["edge_map_bwd_tc_all"] = SIGNATURES["edge_map_bwd_tc"]
RESTYPES = {"gcp_edge_map_bwd_tc_image_bytes": _LL, "gcp_edge_map_tc_image_bytes": _LL}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def build(names: Iterable[str] = tuple(SIGNATURES), ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels, one ``nvcc`` per source, all started
    together.  Returns each compiler's output; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [compiler, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    outputs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        outputs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            # atomic: another process may be loading the previous build
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(outputs[n] for n in failed)
        )
    return outputs


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of kernel library ``name``'s entry
    points on ``lib`` (a build of its source).  An entry point the build
    lacks is left out: an older version of the source, as ``k2_versions.py``
    times, predates it (a call to it then raises ``AttributeError``)."""
    for fn, argtypes in SIGNATURES[name].items():
        if not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = RESTYPES.get(fn, _I)
    return lib


class _Libraries:
    """Process-wide cache of loaded kernel libraries."""

    def __init__(self):
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if name not in self._libs:
                if _stale(name):
                    build([name])
                lib = ctypes.CDLL(str(library_path(name)))
                bind(lib, name)
                self._libs[name] = lib
            return self._libs[name]


_LIBRARIES = _Libraries()


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if missing or older
    than its sources."""
    return _LIBRARIES.get(name)
