"""ctypes binding of the repo's native text/CSV parser (``cpp/loader.cpp``),
the port of ``data/_native.py``, with the same two C entry points,
``dal_count_dims`` and ``dal_parse_matrix``.

The library is built at first use from ``cpp/loader.cpp`` with the host C++
compiler (``$CXX``, else ``g++``) into ``build/kernels/`` at the root of the
checkout (beside the CUDA kernels), named by a hash of the source and the
flags, so an edited source never loads a stale build. A failed build raises
with the compiler's output: nothing falls back to numpy for want of the
library. A file the built parser declines (a non-zero return: a ragged row,
a hex-float token, an empty CSV field, a missing file) is a decision about
the file, and :mod:`.formats` then takes the numpy route, as the JAX
package's loader does, so that both packages accept and refuse the same
files.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from distributed_active_learning_tpu_torch.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "cpp" / "loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"no C++ compiler {cxx!r} on PATH ($CXX): the native loader "
                           f"({SOURCE}) cannot be built")
    return found


def lib_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libdal_loader-{h.hexdigest()[:12]}.so"


def load() -> ctypes.CDLL:
    """The loaded library, built first if it is not there."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = lib_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_cxx(), *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building the native loader from {SOURCE} failed "
                                   f"(rc {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        # int dal_parse_matrix(const char* path, int is_csv, float* out,
        #                      long capacity, long* n_rows, long* n_cols)
        lib.dal_parse_matrix.restype = ctypes.c_int
        lib.dal_parse_matrix.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ]
        # int dal_count_dims(const char* path, int is_csv, long* n_rows, long* n_cols)
        lib.dal_count_dims.restype = ctypes.c_int
        lib.dal_count_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        _lib = lib
        return lib


def parse(path: str, is_csv: bool) -> Optional[np.ndarray]:
    """The file as a ``[rows, cols]`` float32 matrix (``strtof``: each token
    rounded once), or None when the parser declines the file."""
    lib = load()
    n_rows, n_cols = ctypes.c_long(0), ctypes.c_long(0)
    rc = lib.dal_count_dims(path.encode(), int(is_csv), ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc != 0 or n_rows.value <= 0 or n_cols.value <= 0:
        return None
    expect = (n_rows.value, n_cols.value)
    out = np.empty(expect, dtype=np.float32)
    rc = lib.dal_parse_matrix(path.encode(), int(is_csv),
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
                              ctypes.byref(n_rows), ctypes.byref(n_cols))
    if rc != 0 or (n_rows.value, n_cols.value) != expect:
        # The dims changed between the count and the parse (the file changed
        # mid-read): the packed buffer would not match the array's strides.
        return None
    return out


def try_load_matrix(path: str, sep: Optional[str]) -> Optional[np.ndarray]:
    """A whitespace-separated dense matrix, or None when the parser declines
    it. Only ``sep=None`` (any whitespace) is parsed natively: an explicit
    ``sep=" "`` means numpy's strict single-space rule, which the C
    tokenizer does not follow, so it is declined (as in the JAX package)."""
    if sep is not None:
        return None
    return parse(path, is_csv=False)


def try_load_csv_label_last(path: str) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """A CSV with a header and a quoted label last, as ``(features, labels
    int32)``, or None when the parser declines it."""
    mat = parse(path, is_csv=True)
    if mat is None:
        return None
    return np.ascontiguousarray(mat[:, :-1]), mat[:, -1].astype(np.int32)
