"""Build and load the hand-written CUDA kernels.

Each source in ``csrc/`` (:data:`SOURCES`) is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface
and loaded with ``ctypes`` (no PyTorch headers: a build takes seconds,
not minutes).  A build runs at first use, into ``_build/`` beside this
file (listed in ``.gitignore``); each library's name carries a hash of
its own source, so an edited source never loads a stale build and
editing one source rebuilds only its library.  :func:`load_all` starts
one ``nvcc`` per missing library, all at once.  The sources in the
package are the only inputs.
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
from typing import Dict, Iterable, Tuple

_HERE = pathlib.Path(__file__).resolve().parent
#: library name -> its CUDA source
SOURCES: Dict[str, pathlib.Path] = {
    "segmented_copy": _HERE / "csrc" / "segmented_copy.cu",
    "flash_attention": _HERE / "csrc" / "flash_attention.cu",
}
BUILD_DIR = _HERE / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per library: ``{"seconds": nvcc wall time (0.0 when a cached library
#: was loaded), "log": nvcc's output including -Xptxas -v, "path": the
#: library}``
build_infos: Dict[str, Dict[str, object]] = {name: {} for name in SOURCES}
#: the segmented-copy library's entry of :data:`build_infos`
build_info = build_infos["segmented_copy"]

_vp, _ll, _int, _f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_float)
_SIGNATURES = {
    "segmented_copy": {
        # arena, n_rows, pool_bytes, desc, kb, flat, flat_len, seg,
        # ordered, stream
        "dart_segmented_scatter": [_vp, _ll, _ll, _vp, _int, _vp, _ll, _int,
                                   _int, _vp],
        # arena, n_rows, pool_bytes, desc, kb, out, seg, stream
        "dart_segmented_gather": [_vp, _ll, _ll, _vp, _int, _vp, _int, _vp],
        # arena, n_rows, pool_bytes, desc, kb, flat, flat_len, seg, op,
        # dtype, ordered, out (or NULL), stream
        "dart_segmented_accumulate": [_vp, _ll, _ll, _vp, _int, _vp, _ll,
                                      _int, _int, _int, _int, _vp, _vp],
    },
    "flash_attention": {
        # q, k, v, o, B, S, T, Hq, Hkv, hd, q strides (b, s, h),
        # k strides, v strides, o strides, dtype, causal, scale, stream
        "dart_flash_attention": [_vp, _vp, _vp, _vp, _int, _ll, _ll, _int,
                                 _int, _int] + [_ll] * 12
                                + [_int, _int, _f, _vp],
    },
}


def library_path(name: str) -> pathlib.Path:
    """Where library ``name`` is built: ``_build/lib<name>_<hash>.so``,
    the hash being the first 16 hex digits of its source's SHA-256."""
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def _start(name: str, out: pathlib.Path) -> Tuple[subprocess.Popen, list,
                                                 pathlib.Path, float]:
    """Start nvcc on ``name``'s source, building into a temporary file;
    its output goes to a log file beside it (a pipe left unread while
    another build is awaited could fill and stall it)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCES[name])]
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, cmd, tmp, time.perf_counter()


def _wait_all(started: Dict[str, tuple],
              paths: Dict[str, pathlib.Path]) -> None:
    """Wait for every build started by :func:`_start`, timing each to
    its own exit; raise the first failure once all have ended."""
    pending, failure = dict(started), None
    while pending:
        for name, (proc, cmd, tmp, t0) in list(pending.items()):
            if proc.poll() is None:
                continue
            seconds = time.perf_counter() - t0
            del pending[name]
            log_path = tmp.with_suffix(".log")
            log = log_path.read_text()
            log_path.unlink()
            if proc.returncode != 0:
                failure = failure or RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                    f"{log}")
                continue
            os.replace(tmp, paths[name])
            build_infos[name].update(seconds=seconds, log=log)
        time.sleep(0.02)
    if failure is not None:
        raise failure


def _open(name: str, path: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn_name, args in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.dart_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dart_cuda_error_string.restype = ctypes.c_char_p
    build_infos[name]["path"] = str(path)
    return lib


def load_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, ctypes.CDLL]:
    """Load the named libraries, building every missing one first: one
    ``nvcc`` per source, all started together."""
    names = list(names)
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        paths = {n: library_path(n) for n in todo}
        started = {n: _start(n, paths[n]) for n in todo
                   if not paths[n].exists()}
        _wait_all(started, paths)
        for n in todo:
            if n not in started:
                build_infos[n].update(seconds=0.0, log="(cached build)")
            _LIBS[n] = _open(n, paths[n])
        return {n: _LIBS[n] for n in names}


def load(name: str = "segmented_copy") -> ctypes.CDLL:
    """Library ``name``, built on first use."""
    lib = _LIBS.get(name)
    return lib if lib is not None else load_all([name])[name]


def error_string(code: int, name: str = "segmented_copy") -> str:
    lib = load(name)
    return f"{code} ({lib.dart_cuda_error_string(code).decode()})"
