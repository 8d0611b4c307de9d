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

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
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
    "ring_hop": {"ring_step": [_P, _I, _I, _P], "ring_hop_enable_peer": [_I, _I],
                 "ring_hop_ipc_alloc": [_I, _L, _P, _P], "ring_hop_ipc_open": [_I, _P, _P],
                 "ring_hop_ipc_handle_size": []},
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
    "cudnn_workspace": {
        "cudnn_conv_workspace": [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _P, _P],
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


def _cudnn_args() -> list:
    """Compile and link flags of ``csrc/cudnn_workspace.cu``: the headers
    of the cuDNN library PyTorch has loaded (beside it, else the system's)
    and that library itself, so the query asks the very cuDNN that runs the
    convolutions. Raises when either is missing."""
    import torch

    torch.backends.cudnn.version()  # PyTorch loads its cuDNN
    libs = sorted({ln.split()[-1] for ln in open("/proc/self/maps")
                   if "/libcudnn.so." in ln.rsplit(None, 1)[-1]})
    if not libs:
        raise RuntimeError("no cuDNN library is loaded in this process: PyTorch's cuDNN is "
                           "needed to ask for a convolution's workspace")
    lib = Path(libs[0])
    home = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")
    for inc in (lib.parent.parent / "include", Path("/usr/include"),
                Path("/usr/include/x86_64-linux-gnu"), home / "include"):
        if (inc / "cudnn.h").exists():
            return ["-I", str(inc), "-Xlinker", str(lib), "-Xlinker", "-rpath", "-Xlinker",
                    str(lib.parent)]
    raise RuntimeError(f"cuDNN's headers (cudnn.h) are not beside {lib} nor in the system's "
                       "include directories")


def _lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in sorted([CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    extra = _cudnn_args() if name == "cudnn_workspace" else []
    h.update(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start_build(name: str, verbose: bool) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(CSRC / f"{name}.cu"),
           *(_cudnn_args() if name == "cudnn_workspace" else ())]
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


# Launch counting. Each wrapper counts one launch of its kernel where it
# launches it (:func:`count_launch`). A launch made while this thread
# captures a CUDA graph is recorded into the graph, not run: it goes to the
# capture's own tally (:func:`capture_tally`), which ``runtime.loop.
# GraphedChunk`` adds to the counters at every replay. The tally is per
# thread, so a capture on a background thread (the service's precompile
# worker) never takes launches that another thread made meanwhile.
_counting = threading.local()
_count_lock = threading.Lock()


def count_launch(module, name: str = "launches", n: int = 1) -> None:
    """Add ``n`` launches to ``module.<name>``, or to this thread's capture
    tally while it captures a graph."""
    tally = getattr(_counting, "tally", None)
    if tally is not None:
        tally[(module, name)] = tally.get((module, name), 0) + n
        return
    with _count_lock:
        setattr(module, name, getattr(module, name) + n)


@contextlib.contextmanager
def capture_tally(keys=()):
    """Count this thread's launches into a fresh dict ``{(module, name):
    n}`` (``keys`` start at 0) instead of the modules' counters."""
    tally = {k: 0 for k in keys}
    prev = getattr(_counting, "tally", None)
    _counting.tally = tally
    try:
        yield tally
    finally:
        _counting.tally = prev


# Work accounting. A counting mode (``analysis.roofline.program_cost``, the
# memory pre-flight of ``analysis.memory``) installs a :class:`WorkTally` on
# this thread (:func:`work_tally`). Each wrapper declares its kernel's work
# from the shapes it was given, where it counts its launch
# (:func:`kernel_work`): the tally adds that declaration and no operation
# made inside the wrapper, whichever route computes the function there (the
# CUDA kernel, its plain version on the CPU, the meta stand-in of a priced
# program). So a program has one cost whatever implements its kernels.
class WorkTally:
    """Declared kernel work: ``kernels[name] = {"calls", "flops",
    "bytes"}``, the distinct launch shapes a wrapper gave (``launches``:
    ``{"kernel", **shape}``, for the shared-memory pre-flight); ``inside``
    > 0 while a wrapper's body runs (its operations are the kernel's, not
    the program's). A tally made with ``record`` (the program auditor's
    trace, ``analysis/auditor.py``) also keeps every declaration in order
    (``log``) and every outermost collective call (``collectives``, from
    :func:`collective_work`); ``in_collective`` > 0 while one runs."""

    def __init__(self, record: bool = False):
        self.kernels: Dict[str, dict] = {}
        self.launches: list = []
        self.inside = 0
        self.record = record
        self.log: list = []
        self.collectives: list = []
        self.in_collective = 0

    def declare(self, name: str, flops: float, nbytes: float, shape=None) -> None:
        row = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
        row["calls"] += 1
        row["flops"] += float(flops)
        row["bytes"] += float(nbytes)
        if shape is not None:
            launch = {"kernel": name, **shape}
            if launch not in self.launches:
                self.launches.append(launch)
        if self.record:
            self.log.append({"kernel": name, "flops": float(flops), "bytes": float(nbytes),
                             **(shape or {})})


@contextlib.contextmanager
def work_tally(tally: WorkTally):
    """Declare this thread's kernel work into ``tally`` for the block."""
    prev = getattr(_counting, "work", None)
    _counting.work = tally
    try:
        yield tally
    finally:
        _counting.work = prev


class _Declared:
    """The body of one wrapper call under a work tally (:func:`kernel_work`)."""

    __slots__ = ("tally", "name", "cost", "shape")

    def __init__(self, tally: WorkTally, name: str, cost, shape):
        self.tally, self.name, self.cost, self.shape = tally, name, cost, shape

    def __enter__(self):
        if self.tally.inside == 0:
            self.tally.declare(self.name, *self.cost(),
                               shape=self.shape() if self.shape is not None else None)
        self.tally.inside += 1

    def __exit__(self, *exc):
        self.tally.inside -= 1
        return False


_NO_WORK = contextlib.nullcontext()


def kernel_work(name: str, cost, shape=None):
    """The body of a wrapper of kernel ``name``: ``cost()`` gives its work
    (``(flops, bytes)`` from ``analysis.costs``) and ``shape()`` its launch
    shape (a dict; ``shape`` may be None). Both are called only when this
    thread has a tally installed, which gets the work once, with the body's
    own operations left out of it; otherwise the context does nothing. A
    wrapper called inside another's body declares nothing."""
    tally = getattr(_counting, "work", None)
    if tally is None:
        return _NO_WORK
    return _Declared(tally, name, cost, shape)


class _Collective:
    """One collective call under a recording tally (:func:`collective_work`)."""

    __slots__ = ("tally", "entry")

    def __init__(self, tally: WorkTally, entry):
        self.tally, self.entry = tally, entry

    def __enter__(self):
        if self.tally.in_collective == 0:
            self.tally.collectives.append(self.entry())
        self.tally.in_collective += 1

    def __exit__(self, *exc):
        self.tally.in_collective -= 1
        return False


def caller(skip) -> str:
    """``file:line (function)`` of the innermost calling frame whose file is
    not under one of the paths ``skip`` (nor Python's own ``<...>``), the
    port's files relative to the checkout."""
    frame = sys._getframe(1)
    while frame is not None:
        path = frame.f_code.co_filename
        if not path.startswith(skip) and not path.startswith("<"):
            rel = (os.path.relpath(path, os.path.dirname(_HERE)) if path.startswith(_HERE)
                   else os.path.basename(path))
            return f"{rel}:{frame.f_lineno} ({frame.f_code.co_name})"
        frame = frame.f_back
    return "<unknown>"


_HERE = os.path.dirname(os.path.abspath(__file__))
#: The collectives' own files, which :func:`collective_work` names no call in.
_COLLECTIVE_FILES = tuple(os.path.join(_HERE, *f) for f in (
    ("kernels.py",), ("parallel", "collectives.py"), ("ops", "ring_topk.py")))


def collective_work(name: str, kind: str, parts):
    """The body of a collective over the mesh's shards (``parallel/
    collectives.py``, a ring hop of ``ops/ring_topk.py``): ``parts`` are
    the per-shard operands (tensors, or tuples of them). Under a recording
    tally the outermost call is logged as ``{"name", "kind", "shards",
    "operands", "shard_bytes", "location"}``: ``kind`` is ``"reduce"`` (a
    sum in shard order, the port's ``psum``), ``"gather"`` (every shard's
    operand to every shard, ``all_gather``), ``"exchange"`` (``all_to_all``)
    or ``"ring"`` (one hop of windows, ``ppermute``); ``operands`` are one
    shard's ``(dtype, shape)`` and ``shard_bytes`` their bytes, which is
    what crosses each link. Otherwise the context does nothing."""
    tally = getattr(_counting, "work", None)
    if tally is None or not tally.record:
        return _NO_WORK
    where = caller(_COLLECTIVE_FILES)

    def entry():
        first = parts[0] if len(parts) else ()
        ts = [first] if hasattr(first, "dtype") else [t for t in first if hasattr(t, "dtype")]
        return {"name": name, "kind": kind, "shards": len(parts),
                "operands": [(str(t.dtype).replace("torch.", ""), tuple(t.shape)) for t in ts],
                "shard_bytes": float(sum(t.numel() * t.element_size() for t in ts)),
                "location": where}

    return _Collective(tally, entry)


def check(name: str, err: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
