"""Port parity, the utils: debug (failure detection), metrics, profiling,
checkpoints, the viewer and its live loop, and the CLI — the tests of
``tests/test_utils.py`` on the port's scenes (CPU; the port has no
counterpart of the rolling ``Meter``), plus checkpoints
written by one package and loaded by the other (leaves exactly equal,
the structure text equal to ``str(jax.tree.structure(...))``).
"""

import os

import numpy as np
import pytest
import torch

from wgpu_physics_engine_torch.core import config as cfg
from wgpu_physics_engine_torch.models import scenes
from wgpu_physics_engine_torch.utils import (checkpoint, debug, metrics,
                                             profiling, viewer)


def _cloth_scene():
    return scenes.ClothScene(config=cfg.ClothConfig(height=4, width=4),
                             use_kernel=False, device="cpu")


def test_assert_finite_passes_and_raises():
    debug.assert_finite({"a": torch.ones(3)})
    with pytest.raises(ValueError, match="non-finite"):
        debug.assert_finite({"a": torch.tensor([1.0, float("nan")])})


def test_checked_wrapper_raises_on_nan():
    def bad_step(state):
        return state * float("inf") * 0.0

    wrapped = debug.checked(bad_step)
    with pytest.raises(FloatingPointError):
        np.asarray(wrapped(torch.ones(4)))
    assert torch.equal(debug.checked(lambda s: s + 1)(torch.ones(2)),
                       torch.full((2,), 2.0))


def test_find_nan_step():
    def step(x):
        # goes non-finite at step 7 (float32 overflows at 2^128)
        return x * 1e5

    idx = debug.find_nan_step(step, torch.tensor(1.0), 32, chunk=4)
    assert idx == 7


def test_viewer_png_gif(tmp_path):
    img = np.random.rand(8, 8, 3).astype(np.float32)
    viewer.save_png(img, str(tmp_path / "a.png"))
    viewer.save_gif([img, img * 0.5], str(tmp_path / "a.gif"), fps=5)
    assert (tmp_path / "a.png").exists()
    assert (tmp_path / "a.gif").exists()


def test_cli_single_frame(tmp_path):
    from wgpu_physics_engine_torch.__main__ import main

    out = str(tmp_path / "cube.png")
    assert main(["cube", "--out", out, "--size", "24", "32",
                 "--device", "cpu"]) == 0
    from PIL import Image

    assert Image.open(out).size == (32, 24)


def test_cli_datagen(tmp_path):
    from wgpu_physics_engine_torch.__main__ import main

    outdir = str(tmp_path / "dg")
    assert main(["datagen", "--worlds", "2", "--frames", "1", "--grid", "8",
                 "--size", "16", "16", "--outdir", outdir,
                 "--device", "cpu"]) == 0
    files = os.listdir(outdir)
    assert any(f.endswith(".npy") for f in files)
    arr = np.load(os.path.join(outdir, sorted(files)[0]))
    assert arr.shape == (2, 16, 16, 3)


def test_ansi_frame_renders():
    img = np.zeros((16, 16, 3), np.float32)
    img[:8, :, 0] = 1.0                       # top half red
    s = viewer.ansi_frame(img, max_cols=16)
    assert "\x1b[38;2;255;0;0m" in s          # red foreground (top pixels)
    assert s.count("\n") == 7                 # 16 rows → 8 char lines


def test_parse_keys_arrows_and_chars():
    keys = viewer.parse_keys(b"\x1b[Aq+\x1b[D g")
    assert keys == ["up", "q", "+", "left", " ", "g"]


def test_live_key_dispatch_drives_scene():
    """The live-loop key table steers orbit/zoom and the sliders (the
    reference's mouse orbit and egui inputs, cloth.rs:1383-1451,
    1497-1499)."""
    s = _cloth_scene()
    th0, r0 = s._orbit["theta"], s._orbit["radius"]
    assert viewer.handle_key(s, "left") is None
    assert s._orbit["theta"] == pytest.approx(th0 - 0.15)
    viewer.handle_key(s, "up")
    viewer.handle_key(s, "+")
    assert s._orbit["radius"] < r0
    g0 = float(s.params.gravity)
    viewer.handle_key(s, "G")
    assert float(s.params.gravity) == pytest.approx(g0 * 1.1)
    ts0 = s.time_scale
    viewer.handle_key(s, "t")
    assert s.time_scale == pytest.approx(ts0 * 0.8)
    assert viewer.handle_key(s, " ") == "pause"
    assert viewer.handle_key(s, "q") == "quit"
    assert viewer.handle_key(s, "z") is None   # unbound key is a no-op


def test_live_key_dispatch_full_panel():
    """Every remaining egui control is key-reachable: light azimuth,
    shininess, ks, the specular toggle (globe.rs:491-545), speed damping
    and the state-resetting particle-radius slider (cloth.rs:1409-1435)."""
    s = _cloth_scene()
    p0 = np.asarray(s.light.position)
    viewer.handle_key(s, "L")
    p1 = np.asarray(s.light.position)
    assert not np.allclose(p0, p1)
    assert np.linalg.norm(p1) == pytest.approx(np.linalg.norm(p0), rel=1e-5)
    assert p1[1] == p0[1]                      # azimuth only: y fixed
    sh0 = s.light.shininess
    viewer.handle_key(s, "S")
    assert s.light.shininess == pytest.approx(min(sh0 * 1.25, 256.0))
    ks0 = s.light.ks
    viewer.handle_key(s, "k")
    assert s.light.ks == pytest.approx(max(ks0 - 0.1, 0.0))
    assert s.light.compute_specular
    viewer.handle_key(s, "x")
    assert not s.light.compute_specular
    d0 = float(s.params.speed_damp)
    viewer.handle_key(s, "d")
    assert float(s.params.speed_damp) == pytest.approx(d0 / 1.02)
    # radius resets the cloth state, like the reference's slider
    s.state = s.state._replace(pos=s.state.pos + 1.0)
    r0 = float(s.params.particle_radius)
    viewer.handle_key(s, "R")
    assert float(s.params.particle_radius) == pytest.approx(r0 * 1.1)
    from wgpu_physics_engine_torch.core.state import init_cloth_state

    assert torch.equal(s.state.pos, init_cloth_state(s.config,
                                                     device="cpu").pos)


def test_status_line_readouts():
    """The status line carries the reference's egui info labels
    (cloth.rs:1438-1448): fps, instance count, spring count."""
    from wgpu_physics_engine_torch.core.topology import spring_counts

    s = _cloth_scene()
    line = viewer.status_line(s, paused=True)
    assert "inst 16" in line
    assert f"springs {sum(spring_counts(4, 4))}" in line
    assert "[paused]" in line
    g = scenes.GlobeScene(device="cpu")
    line = viewer.status_line(g)
    assert f"verts {g.mesh.positions.shape[0]}" in line


def test_live_noninteractive_runs(capsys):
    """live() with interactive=False streams frames and exits cleanly (no
    tty required)."""
    viewer.live(_cloth_scene(), seconds=0.2, fps=10, size=(16, 16),
                max_cols=16, interactive=False)
    out = capsys.readouterr().out
    assert "fps" in out and "\x1b[38;2;" in out


def test_parse_events_sgr_mouse():
    """SGR 1006 mouse sequences decode into ('mouse', b, x, y, pressed)
    tuples interleaved with key tokens; malformed sequences degrade to
    characters; parse_keys drops mouse events."""
    buf = (b"\x1b[<0;10;5M"          # left press at (10, 5)
           b"q"
           b"\x1b[<32;12;4M"         # left drag to (12, 4)
           b"\x1b[<0;12;4m"          # release
           b"\x1b[<64;1;1M"          # wheel up
           b"\x1b[A")
    ev = viewer.parse_events(buf)
    assert ev == [("mouse", 0, 10, 5, True), "q",
                  ("mouse", 32, 12, 4, True), ("mouse", 0, 12, 4, False),
                  ("mouse", 64, 1, 1, True), "up"]
    assert viewer.parse_keys(buf) == ["q", "up"]
    assert all(isinstance(e, str)
               for e in viewer.parse_events(b"\x1b[<0;x;2M"))


def test_parse_events_carries_split_escape():
    """An SGR sequence split across a read boundary must not degrade to
    literal chars: parse_events returns the incomplete tail, the caller
    prepends it to the next read."""
    whole = b"q\x1b[<32;120;45M\x1b[A"
    for cut in range(1, len(whole)):
        a, b = whole[:cut], whole[cut:]
        ev1, rest = viewer.parse_events(a, return_rest=True)
        ev2, rest2 = viewer.parse_events(rest + b, return_rest=True)
        assert ev1 + ev2 == [
            "q", ("mouse", 32, 120, 45, True), "up"], f"cut={cut}"
        assert rest2 == b""
    ev, rest = viewer.parse_events(whole, return_rest=True)
    assert rest == b"" and ev == viewer.parse_events(whole)
    ev, rest = viewer.parse_events(b"g\x1b", return_rest=True)
    assert ev == ["g"] and rest == b"\x1b"


def test_live_key_light_xyz():
    """Per-axis light position keys u/U i/I o/O mirror the reference's
    Light X/Y/Z sliders (cloth.rs:1400-1402)."""
    s = _cloth_scene()
    p0 = [float(v) for v in s.light.position]
    for key, axis, d in (("u", 0, -1.0), ("U", 0, +1.0), ("i", 1, -1.0),
                         ("I", 1, +1.0), ("o", 2, -1.0), ("O", 2, +1.0)):
        before = [float(v) for v in s.light.position]
        assert viewer.handle_key(s, key) is None
        after = [float(v) for v in s.light.position]
        assert after[axis] == pytest.approx(before[axis] + d)
        for other in range(3):
            if other != axis:
                assert after[other] == before[other]
    assert [float(v) for v in s.light.position] == pytest.approx(p0)


def test_mouse_drag_orbits_scene():
    """Left-drag orbits the camera, the wheel zooms; release ends the drag
    so the next press doesn't jump."""
    s = _cloth_scene()
    drag = {}
    th0, ph0, r0 = (s._orbit[k] for k in ("theta", "phi", "radius"))
    viewer.handle_mouse(s, ("mouse", 0, 10, 5, True), drag)      # press
    assert s._orbit["theta"] == th0                              # no jump
    viewer.handle_mouse(s, ("mouse", 32, 13, 4, True), drag)     # drag
    assert s._orbit["theta"] == pytest.approx(th0 + 0.04 * 3)
    assert s._orbit["phi"] == pytest.approx(ph0 + 0.08)
    viewer.handle_mouse(s, ("mouse", 0, 13, 4, False), drag)     # release
    assert not drag
    viewer.handle_mouse(s, ("mouse", 32, 20, 9, True), drag)     # new drag
    th1 = s._orbit["theta"]
    viewer.handle_mouse(s, ("mouse", 32, 20, 9, True), drag)
    assert s._orbit["theta"] == th1                              # no motion
    viewer.handle_mouse(s, ("mouse", 64, 1, 1, True), drag)      # wheel up
    assert s._orbit["radius"] == pytest.approx(r0 * 0.9)
    viewer.handle_mouse(s, ("mouse", 65, 1, 1, True), drag)      # wheel dn
    assert s._orbit["radius"] == pytest.approx(r0 * 0.9 * 1.1)


def test_mouse_wheel_with_modifiers_still_zooms():
    """Shift/ctrl-wheel (modifier bits 4/16 set) zooms like the plain
    wheel."""
    s = _cloth_scene()
    r0 = s._orbit["radius"]
    viewer.handle_mouse(s, ("mouse", 68, 1, 1, True), {})   # shift-wheel up
    assert s._orbit["radius"] == pytest.approx(r0 * 0.9)
    viewer.handle_mouse(s, ("mouse", 81, 1, 1, True), {})   # ctrl-wheel dn
    assert s._orbit["radius"] == pytest.approx(r0 * 0.9 * 1.1)


# ---------------------------------------------------------------------------
# Beyond the JAX tests: checkpoints across the packages, profiling, CLI
# ---------------------------------------------------------------------------

def _state_tree():
    from wgpu_physics_engine_torch.core.state import (ClothParams,
                                                      init_cloth_state)

    c = cfg.ClothConfig(height=5, width=4)
    return {"state": init_cloth_state(c, device="cpu"),
            "params": ClothParams.from_config(c, device="cpu"),
            "extra": (torch.arange(3, dtype=torch.int32), [torch.ones(2)])}


def test_checkpoint_roundtrip_and_mismatch(tmp_path):
    tree = _state_tree()
    tree["state"] = tree["state"]._replace(vel=tree["state"].vel + 0.5)
    path = str(tmp_path / "ck" / "a.npz")
    checkpoint.save(path, tree, meta={"step": 7})
    like = _state_tree()
    got, meta = checkpoint.load(path, like)
    assert meta == {"step": 7}
    assert type(got["state"]) is type(like["state"])
    assert got["state"].pin_mask is None
    assert torch.equal(got["state"].vel, tree["state"].vel)
    assert got["extra"][0].dtype == torch.int32
    assert isinstance(got["extra"][1], list)
    bad = _state_tree()
    bad["extra"] = (torch.arange(4, dtype=torch.int32), [torch.ones(2)])
    with pytest.raises(checkpoint.CheckpointMismatchError,
                       match=r"\['extra'\]\[0\]"):
        checkpoint.load(path, bad)
    with pytest.raises(checkpoint.CheckpointMismatchError, match="treedef"):
        checkpoint.load(path, {"state": like["state"]})
    assert checkpoint.load(path, bad, strict=False)[0]["extra"][0].shape == (3,)


def test_checkpoint_across_packages(tmp_path):
    """A checkpoint written by the JAX package loads in the port's, and the
    port's in JAX's; the structure text is JAX's."""
    import jax
    from wgpu_physics_engine_tpu.core import config as jcfg
    from wgpu_physics_engine_tpu.core import state as jstate
    from wgpu_physics_engine_tpu.utils import checkpoint as jck

    c = jcfg.ClothConfig(height=5, width=4)
    jtree = {"state": jstate.init_cloth_state(c),
             "params": jstate.ClothParams.from_config(c),
             "extra": (jax.numpy.arange(3, dtype=jax.numpy.int32),
                       [jax.numpy.ones(2)])}
    ttree = _state_tree()
    assert checkpoint.treedef_str(ttree) == str(jax.tree.structure(jtree))
    jpath = str(tmp_path / "jax.npz")
    jck.save(jpath, jtree, meta={"from": "jax"})
    got, meta = checkpoint.load(jpath, ttree)
    assert meta == {"from": "jax"}
    for (_, a), (_, b) in zip(checkpoint._flatten(got),
                              checkpoint._flatten(jtree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tpath = str(tmp_path / "torch.npz")
    checkpoint.save(tpath, ttree)
    back, _ = jck.load(tpath, jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_profiling_on_cpu(tmp_path):
    calls = []

    def step(x):
        calls.append(1)
        return x + 1

    best, out = profiling.timed(step, torch.zeros(3), warmup=1, repeats=2)
    assert best >= 0.0 and len(calls) == 3 and torch.equal(out,
                                                           torch.ones(3))
    profiling.sync({"a": torch.ones(1)})
    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    assert (tmp_path / "tr" / "trace.json").exists()
    assert prof.key_averages() is not None
    with pytest.raises(TypeError):      # the caller names the directory
        profiling.trace()


def test_log_run_header_names_torch(caplog):
    import logging

    log = metrics.get_logger("wpe_torch_test")
    log.propagate = True
    with caplog.at_level(logging.INFO, logger="wpe_torch_test"):
        metrics.log_run_header(log)
    assert f"torch {torch.__version__}" in caplog.text


def test_cli_live_streams_ansi_frames(capsys):
    from wgpu_physics_engine_torch.__main__ import main

    assert main(["cloth", "--live", "--seconds", "0.2", "--grid", "4",
                 "--size", "16", "16", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("fps") == 4 and "\x1b[38;2;" in out   # 0.2 s at 20 fps
