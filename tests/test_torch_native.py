"""The port's native host runtime loader (``wgpu_physics_engine_torch/
native.py``) against the Python implementations and the JAX package's
NumPy oracle: the five tests of ``tests/test_native.py``, and that the
library is built under ``build/`` and never into ``native/``.

Tolerances are ``tests/test_native.py``'s: the UV sphere 1e-5 (positions,
normals) and 1e-6 (uvs); the C++ oracle 1e-4 pos / 1e-3 vel through free
fall and impact; the topology and the shards exactly.
"""

import os

import numpy as np
import pytest

from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.models import oracle
from wgpu_physics_engine_torch import native
from wgpu_physics_engine_torch.core import topology as topo
from wgpu_physics_engine_torch.render import geometry


@pytest.fixture(autouse=True)
def _built():
    """Build (or find) the library at test time, not while the module is
    imported; skip where no compiler is found."""
    if not native.available():
        pytest.skip("native lib unavailable (no g++?)")


def test_uv_sphere_matches_python():
    verts, idx = native.generate_uv_sphere(10.0, 16, 32)
    m = geometry.generate_uv_sphere(10.0, 16, 32)
    assert verts.shape[0] == m.positions.shape[0]
    np.testing.assert_allclose(verts[:, :3], m.positions, atol=1e-5)
    np.testing.assert_allclose(verts[:, 3:6], m.normals, atol=1e-5)
    np.testing.assert_allclose(verts[:, 6:], m.uvs, atol=1e-6)
    np.testing.assert_array_equal(idx.astype(np.int32), m.indices)


def test_spring_topology_matches_python():
    c = jcfg.ClothConfig(height=9, width=7)
    scene, _, _ = oracle.make_scene(c)
    p0, p1, counts = native.spring_topology(9, 7)
    s = scene.springs
    assert tuple(counts) == topo.spring_counts(9, 7)
    np.testing.assert_array_equal(p0[:counts[0]], s.struct_p0)
    np.testing.assert_array_equal(p1[:counts[0]], s.struct_p1)
    np.testing.assert_array_equal(p0[counts[0]:counts[0] + counts[1]],
                                  s.shear_p0)
    np.testing.assert_array_equal(p0[counts[0] + counts[1]:], s.bend_p0)


def test_cpp_oracle_matches_numpy_oracle():
    """The C++ stepper (edge-list order) matches the NumPy edge-list oracle
    through free fall and impact at fp32 tolerance."""
    c = jcfg.ClothConfig(height=12, width=12, center=(0.0, 12.0, 0.0),
                         cloth_size=6.0)
    scene, pos0, vel0 = oracle.make_scene(c)
    dt = 1.0 / 480.0
    ref_pos, ref_vel = pos0.copy(), vel0.copy()
    for _ in range(330):
        ref_pos, ref_vel = oracle.substep(scene, ref_pos, ref_vel, dt,
                                          accumulation="edges")
    got_pos, got_vel = native.cloth_simulate(scene, pos0, vel0, dt, 330)
    np.testing.assert_allclose(got_pos, ref_pos, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_vel, ref_vel, atol=1e-3, rtol=1e-3)


def test_shard_writer_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"f32": rng.random((4, 5, 3)).astype(np.float32),
              "u8": rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8),
              "i8": rng.integers(-128, 128, (2, 1, 1, 3, 16), dtype=np.int8),
              "f64": rng.random((3,)),
              "i32": np.arange(7, dtype=np.int32)}
    with native.ShardWriter() as wtr:
        for name, a in arrays.items():
            wtr.submit(str(tmp_path / f"{name}.npy"), a)
        n = wtr.close()
    assert n == len(arrays)
    for name, a in arrays.items():
        b = np.load(tmp_path / f"{name}.npy")
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(a, b)


def test_frame_clock():
    t0 = native.now()
    native.sleep_until(t0 + 0.02)
    assert native.now() - t0 >= 0.019


def test_library_built_under_build_not_native():
    lib = native._load()
    build_root = os.path.realpath(native.BUILD_ROOT)
    path = os.path.realpath(lib._name)
    assert os.path.commonpath([path, build_root]) == build_root
    assert os.path.dirname(path) == os.path.realpath(native.lib_dir())
    root = os.path.dirname(os.path.dirname(os.path.realpath(native.SOURCE)))
    assert os.path.dirname(build_root) == os.path.join(root, "build")
    native_dir = os.path.realpath(os.path.dirname(native.SOURCE))
    assert os.path.commonpath([path, native_dir]) != native_dir
    with open(os.path.join(native.lib_dir(), "build.log")) as f:
        cmd = f.readline()
    assert "wpe_host.cpp" in cmd and "-O2" in cmd and "-fPIC" in cmd
