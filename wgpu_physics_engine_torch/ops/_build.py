"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface (``extern "C"``, raw
pointers, the stream as ``void*``, a ``cudaError_t`` as ``int`` return) and
is compiled by ``nvcc`` into its own shared library at first CUDA use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

into ``build/wpe_torch_kernels/<name>-<hash>/`` beside the package, where
``<hash>`` covers the sources (the ``.cu`` and every ``.cuh``) and the
flags, so an edited kernel is rebuilt and an unchanged one is reused. The library is loaded with
``ctypes``. Nothing here runs at import: importing the ``ops`` modules
needs neither ``nvcc`` nor a card.

``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into one FMA, so
the kernels round exactly where the plain torch versions beside them do.
The ``ptxas`` report (registers, spills) is kept in ``build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "wpe_torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from ops/csrc at first use")


def _sources(name: str):
    main = os.path.join(_CSRC, f"{name}.cu")
    headers = sorted(os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
                     if f.endswith(".cuh"))
    return main, headers


def lib_dir(name: str) -> str:
    main, headers = _sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [main] + headers:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, f"{name}-{h.hexdigest()[:16]}")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists;
    returns the library's path."""
    out_dir = lib_dir(name)
    so = os.path.join(out_dir, f"lib{name}.so")
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    main, _ = _sources(name)
    # compile to a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", _CSRC, "-o", tmp, main]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``lib<name>.so``, declaring each entry
    point's ``argtypes`` from ``signatures`` (``restype`` is ``int``, the
    ``cudaError_t`` of the launch). Every library also exports
    ``wpe_error_string``, which :func:`check` uses."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            lib.wpe_error_string.argtypes = [ctypes.c_int]
            lib.wpe_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.wpe_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
