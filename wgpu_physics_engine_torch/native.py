"""ctypes bindings for the native host runtime (``native/wpe_host.cpp``):
the async ``.npy`` shard writer that datagen writes through, the frame
clock, and the C++ geometry, topology and oracle stepper.

The port's own loader, the counterpart of ``wgpu_physics_engine_tpu/
native.py``. It builds the library from the repo's ``native/wpe_host.cpp``
with ``g++`` (the flags of ``native/Makefile``) at first use:

    g++ -O2 -fPIC -std=c++17 -Wall -shared -o libwpe_host.so wpe_host.cpp
        -lpthread

into ``build/wpe_host/<hash>/`` beside the package, where ``<hash>``
covers the source and the flags; the compiler's output is kept there in
``build.log``. It never writes into ``native/``. Nothing here runs at
import. Every entry point has a pure-Python equivalent, so callers gate on
:func:`available` (False where no compiler or no source is found).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_ROOT, "native", "wpe_host.cpp")
BUILD_ROOT = os.path.join(_ROOT, "build", "wpe_host")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def lib_dir() -> str:
    """``build/wpe_host/<hash>``: the hash covers the source and the
    flags, so an edited source is rebuilt and an unchanged one reused."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile ``native/wpe_host.cpp`` unless an up-to-date library exists;
    returns the library's path. Raises if the compiler is missing or
    fails (its output is in ``build.log``)."""
    out_dir = lib_dir()
    so = os.path.join(out_dir, "libwpe_host.so")
    if os.path.exists(so):
        return so
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host runtime is built "
                           "from native/wpe_host.cpp at first use")
    os.makedirs(out_dir, exist_ok=True)
    # compile to a temporary name and rename, so that a concurrent or cut
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE, "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    with open(os.path.join(out_dir, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed building {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.wpe_uv_sphere_counts.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.POINTER(ctypes.c_int),
                                             ctypes.POINTER(ctypes.c_int)]
        lib.wpe_generate_uv_sphere.argtypes = [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_int, f32p, u32p]
        lib.wpe_spring_counts.argtypes = [ctypes.c_int, ctypes.c_int, i32p]
        lib.wpe_spring_topology.argtypes = [ctypes.c_int, ctypes.c_int, i32p,
                                            i32p]
        lib.wpe_cloth_simulate.argtypes = [ctypes.c_int, ctypes.c_int, f32p,
                                           f32p, f32p, f32p, ctypes.c_int]
        lib.wpe_writer_open.restype = ctypes.c_void_p
        lib.wpe_writer_submit2.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_void_p, i64p, ctypes.c_int,
                                           ctypes.c_char_p, ctypes.c_int]
        lib.wpe_writer_pending.argtypes = [ctypes.c_void_p]
        lib.wpe_writer_pending.restype = ctypes.c_int64
        lib.wpe_writer_close.argtypes = [ctypes.c_void_p]
        lib.wpe_writer_close.restype = ctypes.c_int64
        lib.wpe_now.restype = ctypes.c_double
        lib.wpe_sleep_until.argtypes = [ctypes.c_double]
        _lib = lib
        return lib


def available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _load()
        return True
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False


# ---------------------------------------------------------------------------
# Geometry / topology
# ---------------------------------------------------------------------------

def generate_uv_sphere(radius: float, stacks: int, sectors: int):
    """Native UV sphere → (verts [V, 8] = pos|normal|uv, indices [I])."""
    lib = _load()
    nv, ni = ctypes.c_int(), ctypes.c_int()
    lib.wpe_uv_sphere_counts(stacks, sectors, ctypes.byref(nv),
                             ctypes.byref(ni))
    verts = np.empty((nv.value, 8), np.float32)
    idx = np.empty((ni.value,), np.uint32)
    lib.wpe_generate_uv_sphere(radius, stacks, sectors, verts.reshape(-1), idx)
    return verts, idx


def spring_topology(h: int, w: int):
    """Native topology → (p0, p1, counts[3]); struct|shear|bend
    concatenated."""
    lib = _load()
    counts = np.empty(3, np.int32)
    lib.wpe_spring_counts(h, w, counts)
    total = int(counts.sum())
    p0 = np.empty(total, np.int32)
    p1 = np.empty(total, np.int32)
    lib.wpe_spring_topology(h, w, p0, p1)
    return p0, p1, counts


# ---------------------------------------------------------------------------
# C++ oracle stepper
# ---------------------------------------------------------------------------

def pack_params(scene) -> np.ndarray:
    """An oracle scene (``k``, ``c``, ``rest`` per family, ``k_contact``,
    ``mu``, ``mass``, ``gravity``, ``speed_damp``, ``globe_radius``,
    ``particle_radius``) → the native parameter vector (layout documented
    in ``wpe_host.cpp``)."""
    return np.array([
        scene.k[0], scene.k[1], scene.k[2],
        scene.c[0], scene.c[1], scene.c[2],
        scene.rest[0], scene.rest[1], scene.rest[2],
        scene.k_contact, scene.mu, scene.mass, scene.gravity,
        scene.speed_damp,
        np.float32(scene.globe_radius) + np.float32(scene.particle_radius),
        0.0,  # dt slot, set per call
    ], np.float32)


def cloth_simulate(scene, pos: np.ndarray, vel: np.ndarray, dt: float,
                   n_steps: int) -> Tuple[np.ndarray, np.ndarray]:
    """Run the native oracle on ``scene`` (:func:`pack_params`, plus
    ``height``/``width``): ``pos``/``vel`` [N, 3] float32 (copied)."""
    lib = _load()
    h, w = scene.height, scene.width
    pos = np.ascontiguousarray(pos, np.float32).copy()
    vel = np.ascontiguousarray(vel, np.float32).copy()
    scratch = np.zeros_like(pos)
    prm = pack_params(scene)
    prm[15] = np.float32(dt)
    lib.wpe_cloth_simulate(h, w, pos.reshape(-1), vel.reshape(-1),
                           scratch.reshape(-1), prm, n_steps)
    return pos, vel


# ---------------------------------------------------------------------------
# Async shard writer
# ---------------------------------------------------------------------------

class ShardWriter:
    """Background-thread ``.npy`` writer for datagen egress: ``submit``
    copies the array and returns at once, a C++ thread writes the file.

    Accepts any C-contiguous array of the dtypes below (uint8 frames and
    int8 codec coefficients are datagen's); other dtypes are written as
    float32."""

    _DESCR = {
        np.dtype(np.float32): b"<f4", np.dtype(np.float64): b"<f8",
        np.dtype(np.uint8): b"|u1", np.dtype(np.int32): b"<i4",
        np.dtype(np.int64): b"<i8", np.dtype(np.uint32): b"<u4",
        np.dtype(np.float16): b"<f2", np.dtype(np.bool_): b"|b1",
        np.dtype(np.int8): b"|i1", np.dtype(np.int16): b"<i2",
    }

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.wpe_writer_open()

    def submit(self, path: str, array: np.ndarray) -> None:
        arr = np.ascontiguousarray(array)
        descr = self._DESCR.get(arr.dtype)
        if descr is None:
            arr = np.ascontiguousarray(array, np.float32)
            descr = b"<f4"
        shape = np.asarray(arr.shape, np.int64)
        self._lib.wpe_writer_submit2(
            self._h, os.fsencode(path), arr.ctypes.data_as(ctypes.c_void_p),
            shape, arr.ndim, descr, arr.itemsize)

    def pending(self) -> int:
        return int(self._lib.wpe_writer_pending(self._h))

    def close(self) -> int:
        """Drain and join; returns shards written (negative = error count)."""
        n = int(self._lib.wpe_writer_close(self._h))
        self._h = None
        return n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._h is not None:
            self.close()


def now() -> float:
    """Seconds on the native monotonic frame clock."""
    return float(_load().wpe_now())


def sleep_until(t: float) -> None:
    """Sleep until the frame clock reads ``t`` (:func:`now`)."""
    _load().wpe_sleep_until(t)
