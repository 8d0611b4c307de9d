"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles at first use, with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``, into a shared
library with a plain C interface under ``build/kernels/`` at the root of the
checkout, and is loaded with ``ctypes`` (seconds per source, where a build
that includes PyTorch's headers takes minutes). Libraries are named by a
hash of their sources, so an edited source never loads a stale build. Every C
entry point returns ``cudaGetLastError()`` after its launch; :func:`check`
raises on anything but 0.

Nothing here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("forest_leaves", "round_megakernel", "fused_votes", "ring_hop",
           "forest_leaves_transposed", "forest_leaves_segmented", "threefry")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures (argument types) of each source's entry points.
_SIGNATURES = {
    "forest_leaves": {
        "forest_leaves": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
        "forest_leaves_config": [_I, _I, _I, _I, _I, _I, _I, _P],
    },
    "round_megakernel": {
        "round_megakernel": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P],
        "round_megakernel_config": [_I, _I, _I, _I, _I, _I, _I, _P],
    },
    "fused_votes": {
        "fused_votes": [_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P],
        "fused_votes_config": [_I, _I, _I, _I, _I, _I, _I, _P],
    },
    "ring_hop": {"ring_step": [_P, _I, _I, _P], "ring_hop_enable_peer": [_I, _I]},
    "forest_leaves_transposed": {
        "forest_leaves_transposed": [_P, _I, _I, _I, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "forest_leaves_segmented": {
        "forest_leaves_segmented": [_P, _I, _I, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P, _P],
    },
    "threefry": {
        "threefry_uniform": [_P, _L, _P, _P],
        "threefry_categorical": [_P, _I, _L, _P, _L, _P, _P],
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's diagnostics per built source (ptxas register/spill lines when the
# build asked for them), for callers that report build details.
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME): the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted([CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, verbose: bool) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    build_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc {proc.returncode}):\n{log}")
    out = _lib_path(name)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)


def build_all(names: Iterable[str] = SOURCES, verbose: bool = False) -> None:
    """Build every missing library, one ``nvcc`` per source, all started
    together."""
    with _lock:
        procs = {n: _start_build(n, verbose) for n in names}
        errors = []
        for n, p in procs.items():
            if p is None:
                continue
            try:
                _finish_build(n, p)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded[name] = lib
        return _loaded[name]


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
