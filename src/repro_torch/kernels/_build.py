"""Build and load the hand-written CUDA kernels.

``csrc/segmented_copy.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes``
(no PyTorch headers: a build takes seconds, not minutes).  The build
runs at first use, into ``_build/`` beside this file (listed in
``.gitignore``); the library's name carries a hash of the source, so an
edited source never loads a stale build.  The sources in the package
are the only inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

_HERE = pathlib.Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "segmented_copy.cu"
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: ``{"seconds": build wall time (0.0 when a cached library was loaded),
#: "log": nvcc's output including -Xptxas -v, "path": library}``
build_info: Dict[str, object] = {}

_vp, _ll, _int = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # arena, n_rows, pool_bytes, desc, kb, flat, flat_len, seg, ordered,
    # stream
    "dart_segmented_scatter": [_vp, _ll, _ll, _vp, _int, _vp, _ll, _int,
                               _int, _vp],
    # arena, n_rows, pool_bytes, desc, kb, out, seg, stream
    "dart_segmented_gather": [_vp, _ll, _ll, _vp, _int, _vp, _int, _vp],
    # arena, n_rows, pool_bytes, desc, kb, flat, flat_len, seg, op, dtype,
    # ordered, out (or NULL), stream
    "dart_segmented_accumulate": [_vp, _ll, _ll, _vp, _int, _vp, _ll, _int,
                                  _int, _int, _int, _vp, _vp],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "segmented-copy kernels cannot be built")


def _compile(out: pathlib.Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(seconds=seconds, log=proc.stdout + proc.stderr)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        path = BUILD_DIR / f"libsegmented_copy_{digest}.so"
        if not path.exists():
            _compile(path)
        else:
            build_info.update(seconds=0.0, log="(cached build)")
        build_info["path"] = str(path)
        lib = ctypes.CDLL(str(path))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.dart_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dart_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
        return lib


def error_string(code: int) -> str:
    lib = load()
    return f"{code} ({lib.dart_cuda_error_string(code).decode()})"
