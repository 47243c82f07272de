"""Port parity, the mesh scenes: ``render.geometry`` (``Mesh``,
``generate_uv_sphere``, ``cube_mesh``), ``shading.diffuse_only``, the
triangle rasterizer (``DeviceMesh``, ``draw_mesh`` with its brute and
tile-binned resolvers) and ``CubeScene``, ``TexturedCubeScene`` and
``GlobeScene`` with the ``cube``, ``textured`` and ``globe`` CLI, on the
CPU against the JAX package; and the port's frames of the golden scenes
against ``tests/golden/*.png``.

Tolerances: geometry bit for bit (the same numpy code). ``draw_mesh``:
the covered pixels equal, depth within 1e-6, colour within 1e-4 and the
dropped-candidate count equal. JAX transforms the vertices with matmuls
(FMA-contracted on the CPU), the port writes them out, so the view-space
position and normal that feed the shading, and the uv, differ by ulps
(measured up to 2.5e-5 in colour at 48×64). Scenes: the same contract on
>= 99.9% of pixels. Golden frames: at most 2 in u8 on < 2% of pixels,
the tolerance of ``tests/test_render.py::test_golden_frame``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cuda import golden_frame_diff
from wgpu_physics_engine_tpu import render as JR
from wgpu_physics_engine_tpu.core import config as jcfg
from wgpu_physics_engine_tpu.models import scenes as jscenes
from wgpu_physics_engine_tpu.render import shading as jshading
from wgpu_physics_engine_tpu.render import texture as JT
from wgpu_physics_engine_torch import render as TR
from wgpu_physics_engine_torch.core import config as tcfg
from wgpu_physics_engine_torch.models import scenes as tscenes
from wgpu_physics_engine_torch.render import shading as tshading
from wgpu_physics_engine_torch.render import texture as TT

LIGHT = tcfg.LightConfig()
JLIGHT = jcfg.LightConfig()


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def cam(radius=40.0, phi=0.4, theta=0.5, aspect=1.0):
    return TR.make_camera(tcfg.CameraConfig(radius=radius, phi=phi,
                                            theta=theta), aspect=aspect)


def _same_camera(jc):
    """The port's Camera holding the JAX camera's exact values."""
    return TR.Camera(*(torch.tensor(np.asarray(a)) for a in jc))


# --- geometry and shading ---

@pytest.mark.parametrize("stacks,sectors", [(16, 32), (64, 128), (5, 7)])
def test_uv_sphere_equals_jax(stacks, sectors):
    got = TR.geometry.generate_uv_sphere(10.0, stacks, sectors)
    ref = JR.geometry.generate_uv_sphere(10.0, stacks, sectors)
    for f in ("positions", "normals", "uvs", "indices"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert got.colors is None and len(got.indices) == 3 * (
        2 * stacks * sectors - 2 * sectors)


def test_cube_mesh_equals_jax():
    for half in (1.0, 2.5):
        got, ref = TR.geometry.cube_mesh(half), JR.geometry.cube_mesh(half)
        for f in ("positions", "normals", "uvs", "indices", "colors"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_diffuse_only_matches():
    rng = np.random.default_rng(3)
    pos = rng.normal(0, 5, (3, 8, 9)).astype(np.float32)
    pos[2] -= 20.0
    nrm = rng.normal(0, 1, (3, 8, 9)).astype(np.float32)
    alb = rng.uniform(0, 1, (8, 9, 3)).astype(np.float32)
    lp = np.asarray([3.0, 20.0, -4.0], np.float32)
    got = tshading.diffuse_only(torch.tensor(pos), torch.tensor(nrm),
                                torch.tensor(alb), torch.tensor(lp), LIGHT)
    ref = jshading.diffuse_only(jnp.asarray(pos), jnp.asarray(nrm),
                                jnp.asarray(alb), jnp.asarray(lp), JLIGHT)
    np.testing.assert_allclose(_np(got), np.asarray(ref), atol=1e-6, rtol=0)


# --- draw_mesh against JAX ---

def _mesh_case(name):
    if name == "cube":
        return (TR.geometry.cube_mesh(1.0),
                dict(radius=5.0, phi=0.5, theta=0.7))
    return (TR.geometry.generate_uv_sphere(10.0, 16, 32),
            dict(radius=30.0, phi=0.4, theta=0.5))


# binned with a window, candidate chunk and big-triangle list small enough
# that both packages drop geometry (and report it)
RESOLVERS = {"brute": dict(binned=False), "binned": dict(binned=True),
             "binned_truncated": dict(binned=True, window=16, cand_chunk=8,
                                      big_capacity=4)}


def _draw_both(mesh_name, mode, resolver, h=48, w=64):
    host, c = _mesh_case(mesh_name)
    jc = JR.make_camera(jcfg.CameraConfig(**c), aspect=w / h)
    kw = dict(RESOLVERS[resolver], mode=mode, return_stats=True)
    jkw, tkw = dict(kw), dict(kw)
    if mode != "color":
        tex = np.asarray(JT.checkerboard())
        jkw.update(texture=jnp.asarray(tex), light=JLIGHT)
        tkw.update(texture=torch.tensor(tex), light=LIGHT)
    ref, rd = JR.draw_mesh(JR.clear(h, w), jc, JR.DeviceMesh.from_host(host),
                           **jkw)
    got, gd = TR.draw_mesh(TR.clear(h, w), _same_camera(jc),
                           TR.DeviceMesh.from_host(host), **tkw)
    return got, gd, ref, int(rd)


@pytest.mark.parametrize("resolver", list(RESOLVERS))
@pytest.mark.parametrize("mesh_name,mode", [("cube", "color"),
                                            ("cube", "diffuse"),
                                            ("sphere", "texture"),
                                            ("sphere", "phong")])
def test_draw_mesh_matches_jax(mesh_name, mode, resolver):
    got, dropped, ref, rdropped = _draw_both(mesh_name, mode, resolver)
    assert dropped == rdropped
    if resolver == "binned_truncated":
        assert dropped > 0
    else:
        assert dropped == 0
    hit, rhit = _np(got.depth) < 1.0, np.asarray(ref.depth) < 1.0
    assert hit.sum() > 300
    np.testing.assert_array_equal(hit, rhit)
    np.testing.assert_allclose(_np(got.depth), np.asarray(ref.depth),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(got.color), np.asarray(ref.color),
                               atol=1e-4, rtol=0)


# --- mirrors of tests/test_render.py ---

def _img_close(a, b, frac=0.005, tol=1e-3):
    """Rendered-image equality up to rare z-fight/edge-tie pixels."""
    d = np.abs(_np(a) - _np(b)).max(axis=-1)
    assert (d > tol).mean() <= frac, f"{(d > tol).mean():.2%} pixels differ"


def test_mesh_raster_matches_analytic_globe():
    """The rasterizer over a finely tessellated UV sphere converges to the
    analytic ray-sphere image (same shading contract)."""
    c = cam()
    fbA = TR.draw_globe(TR.clear(64, 64), c, 10.0, TT.checkerboard(), LIGHT)
    m = TR.DeviceMesh.from_host(TR.geometry.generate_uv_sphere(10.0, 32, 64))
    fbB = TR.draw_mesh(TR.clear(64, 64), c, m, texture=TT.checkerboard(),
                       mode="phong", light=LIGHT)
    both = (_np(fbA.depth) < 1.0) & (_np(fbB.depth) < 1.0)
    diff = np.abs(_np(fbA.color) - _np(fbB.color))[both]
    assert np.median(diff) < 0.02
    assert diff.mean() < 0.1


def test_cube_face_colors():
    cube = TR.DeviceMesh.from_host(TR.geometry.cube_mesh(1.0))
    c = TR.make_camera(tcfg.CameraConfig(radius=5.0, phi=0.0, theta=0.0), 1.0)
    img = _np(TR.draw_mesh(TR.clear(64, 64), c, cube, mode="color").color)
    # looking down +z: the front face is +z = red
    np.testing.assert_allclose(img[32, 32], [1, 0, 0], atol=1e-5)


def test_mesh_tiled_matches_brute_sphere():
    mesh = TR.DeviceMesh.from_host(TR.geometry.generate_uv_sphere(10.0, 32, 48))
    c = cam(radius=30.0)
    fb0 = TR.clear(96, 96)
    ref = TR.draw_mesh(fb0, c, mesh, texture=TT.checkerboard(), mode="phong",
                       light=LIGHT, binned=False)
    got, dropped = TR.draw_mesh(fb0, c, mesh, texture=TT.checkerboard(),
                                mode="phong", light=LIGHT, binned=True,
                                return_stats=True)
    assert dropped == 0
    _img_close(got.color, ref.color)
    _img_close(got.depth[..., None], ref.depth[..., None])


def test_mesh_tiled_big_triangles():
    """Triangles spanning many tiles (a close-up cube) go through the
    compacted big-triangle pass and still render correctly."""
    mesh = TR.DeviceMesh.from_host(TR.geometry.cube_mesh(2.0))
    c = cam(radius=4.0)
    fb0 = TR.clear(96, 96)
    ref = TR.draw_mesh(fb0, c, mesh, mode="color", binned=False)
    got, dropped = TR.draw_mesh(fb0, c, mesh, mode="color", binned=True,
                                return_stats=True)
    assert dropped == 0
    _img_close(got.color, ref.color)


def _mixed_mesh():
    sphere = TR.geometry.generate_uv_sphere(6.0, 24, 32)
    cube = TR.geometry.cube_mesh(30.0)     # huge, behind/around the sphere
    return TR.geometry.Mesh(
        positions=np.concatenate([sphere.positions, cube.positions]),
        normals=np.concatenate([sphere.normals, cube.normals]),
        uvs=np.concatenate([sphere.uvs, cube.uvs]),
        indices=np.concatenate([sphere.indices,
                                cube.indices + len(sphere.positions)]))


def test_mesh_tiled_mixed_small_and_big():
    """Small sphere tris + screen-spanning cube tris in one binned draw:
    both paths contribute, the depth test between them holds, and the
    frame equals JAX's."""
    host = _mixed_mesh()
    mesh = TR.DeviceMesh.from_host(host)
    c = cam(radius=20.0)
    fb0 = TR.clear(64, 64)
    ref = TR.draw_mesh(fb0, c, mesh, mode="texture", texture=TT.checkerboard(),
                       binned=False)
    got = TR.draw_mesh(fb0, c, mesh, mode="texture", texture=TT.checkerboard(),
                       binned=True)
    _img_close(got.color, ref.color)
    jc = JR.make_camera(jcfg.CameraConfig(radius=20.0, phi=0.4, theta=0.5),
                        aspect=1.0)
    jref = JR.draw_mesh(JR.clear(64, 64), jc, JR.DeviceMesh.from_host(host),
                        mode="texture", texture=JT.checkerboard(), binned=True)
    got = TR.draw_mesh(fb0, _same_camera(jc), mesh, mode="texture",
                       texture=TT.checkerboard(), binned=True)
    np.testing.assert_array_equal(_np(got.depth) < 1.0,
                                  np.asarray(jref.depth) < 1.0)
    np.testing.assert_allclose(_np(got.color), np.asarray(jref.color),
                               atol=1e-4, rtol=0)


def test_mesh_tiled_window_overflow_reported():
    """An absurdly small window loses geometry but reports it."""
    mesh = TR.DeviceMesh.from_host(TR.geometry.generate_uv_sphere(10.0, 32, 48))
    _, dropped = TR.draw_mesh(TR.clear(64, 64), cam(radius=30.0), mesh,
                              mode="texture", texture=TT.checkerboard(),
                              binned=True, window=8, cand_chunk=8,
                              return_stats=True)
    assert dropped > 0


# --- the scenes and the CLI ---

def _frames_close(got, ref):
    assert got.shape == ref.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    d = np.abs(got - ref).max(-1)
    assert (d <= 1e-4).mean() >= 0.999, (d > 1e-4).mean()


SCENES = {
    "cube": (jscenes.CubeScene, tscenes.CubeScene, {}),
    "textured": (jscenes.TexturedCubeScene, tscenes.TexturedCubeScene, {}),
    "globe": (jscenes.GlobeScene, tscenes.GlobeScene, {}),
    "globe_mesh": (jscenes.GlobeScene, tscenes.GlobeScene,
                   dict(use_mesh=True)),
}


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_renders_match_jax(name):
    jcls, tcls, kw = SCENES[name]
    j, t = jcls(**kw), tcls(device="cpu", **kw)
    for s in (j, t):
        s.update(1.0 / 60.0)
    # the default 600 x 800 frame's shape at a twentieth of its size
    got, ref = t.render(30, 40), j.render(30, 40)
    assert (np.abs(got - np.asarray([0.05, 0.05, 0.08])).max(-1) > 0.01).sum() > 50
    _frames_close(got, ref)


def test_scene_camera_and_light_controls_match():
    j, t = jscenes.GlobeScene(use_mesh=True), tscenes.GlobeScene(
        use_mesh=True, device="cpu")
    for s in (j, t):
        s.orbit(d_theta=0.4, d_phi=0.3, d_radius=-5.0)
        s.set_light(position=(10.0, -5.0, 30.0), ks=1.0, shininess=20.0,
                    compute_specular=True)
        s.resize(40, 30)
    _frames_close(t.render(30, 40), j.render(30, 40))
    for s in (j, t):
        s.set_light(compute_specular=False)
    _frames_close(t.render(30, 40), j.render(30, 40))


@pytest.mark.parametrize("name", ["cube", "textured", "globe"])
def test_cli_mesh_scenes_write_png(name, tmp_path, capsys):
    from PIL import Image

    from wgpu_physics_engine_torch.__main__ import main

    out = tmp_path / f"{name}.png"
    rc = main([name, "--device", "cpu", "--size", "48", "64", "--out",
               str(out)])
    assert rc == 0 and "wrote" in capsys.readouterr().out
    img = np.asarray(Image.open(out).convert("RGB"))
    assert img.shape == (48, 64, 3)
    bg = np.round(np.asarray([0.05, 0.05, 0.08]) * 255).astype(np.uint8)
    assert (img != bg).any(-1).sum() > 100


@pytest.mark.parametrize("cls", [tscenes.CubeScene, tscenes.TexturedCubeScene,
                                 tscenes.GlobeScene,
                                 tscenes.FreeParticleScene])
def test_scene_on_cuda_without_cuda_raises(cls):
    """No hidden fallback: a scene asked for CUDA on a host without it
    fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises((RuntimeError, AssertionError)):
        cls(device="cuda")


@pytest.mark.parametrize("name", ["globe", "cube", "cloth"])
def test_golden_frame_on_cpu(name):
    """The port's frames of the golden scenes (``tests/golden/regen.py``'s
    settings) on the CPU equal the committed JAX frames within
    ``test_golden_frame``'s tolerance."""
    diff = golden_frame_diff(name, "cpu")
    assert diff.max() <= 2, f"max pixel diff {diff.max()}"
    assert (diff > 0).mean() < 0.02, f"{(diff > 0).mean():.1%} pixels differ"
