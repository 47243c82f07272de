"""Headless viewer: PNG frames, animated GIFs and a live terminal view
(NumPy and PIL; the functions of ``wgpu_physics_engine_tpu/utils/viewer.py``).

The reference's winit window and egui panel become files on disk or ANSI
truecolor frames in a terminal (:func:`live`, the CLI's ``--live``), with
the panel's sliders and the orbit camera's mouse input on keys and SGR
mouse events.
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(img: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(to_uint8(img)).save(path)


def save_gif(frames: Iterable[np.ndarray], path: str, fps: int = 30) -> None:
    from PIL import Image

    ims = [Image.fromarray(to_uint8(f)) for f in frames]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)


def ansi_frame(img: np.ndarray, max_cols: int = 80) -> str:
    """Render an image as ANSI 24-bit half-block characters (two pixels per
    character cell) — a live 'window' for any truecolor terminal."""
    h, w = img.shape[:2]
    step = max(1, w // max_cols)
    small = to_uint8(img[::step, ::step])           # 2 small rows per char
    top = small[0::2]
    bot = small[1::2][: top.shape[0]]
    top = top[: bot.shape[0]]
    lines = []
    for tr, br in zip(top, bot):
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(tr, br)
        ]
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def parse_events(buf: bytes, return_rest: bool = False):
    """Split raw terminal bytes into input events.

    Key tokens: 'up'/'down'/'left'/'right' for the arrow escape
    sequences, else single characters. Mouse tokens (SGR 1006 mode,
    ``ESC [ < b ; x ; y M|m``): tuples ``("mouse", b, x, y, pressed)``
    with 1-based cell coordinates — emitted when the live loop has
    enabled ``?1002`` button-motion tracking, giving the reference's
    mouse-drag orbit + wheel zoom (OrbitCamera::input consumed at
    cloth.rs:1497-1499) a terminal equivalent.

    ``return_rest=True`` additionally returns the trailing bytes of an
    escape sequence that was split across the read boundary (a 256-byte
    ``os.read`` can cut an SGR sequence mid-digits); the caller prepends
    them to the next read instead of the sequence degrading to literal
    chars and dropping the event."""
    arrows = {b"A": "up", b"B": "down", b"C": "right", b"D": "left"}
    events, i, rest = [], 0, b""
    while i < len(buf):
        if buf[i:i + 1] == b"\x1b":
            tail = buf[i + 1:]
            if tail[:1] in (b"", b"["):
                body = tail[1:]
                if body[:1] == b"<":
                    j = i + 3
                    while j < len(buf) and buf[j:j + 1] not in (b"M", b"m"):
                        j += 1
                    if j == len(buf):
                        # unterminated SGR prefix: incomplete iff all
                        # bytes so far are valid payload chars
                        if all(c in b"0123456789;" for c in body[1:]):
                            rest = buf[i:]
                            break
                    else:
                        try:
                            b, x, y = (int(v) for v in
                                       buf[i + 3:j].decode().split(";"))
                            events.append(("mouse", b, x, y,
                                           buf[j:j + 1] == b"M"))
                            i = j + 1
                            continue
                        except ValueError:
                            pass  # malformed: fall through as chars
                elif body[:1] in arrows:
                    events.append(arrows[body[:1]])
                    i += 3
                    continue
                elif body == b"":
                    # bare ESC or ESC[ at the end: could grow into an
                    # arrow or mouse sequence next read
                    rest = buf[i:]
                    break
        events.append(chr(buf[i]))
        i += 1
    if return_rest:
        return events, rest
    return events


def parse_keys(buf: bytes) -> list:
    """Key tokens only (see :func:`parse_events`; mouse events dropped)."""
    return [e for e in parse_events(buf) if isinstance(e, str)]


def handle_mouse(scene, ev, drag: dict):
    """Apply one mouse event: left-drag orbits (the reference's
    OrbitCamera mouse input), wheel zooms. ``drag`` carries the last
    drag position between events ({} when no button is down)."""
    _, b, x, y, pressed = ev
    motion = b & 32
    btn = b & ~32 & ~4 & ~8 & ~16      # strip motion + modifier bits
    if btn in (64, 65):                 # wheel up / down (any modifier —
        # tmux/xterm forward shift-wheel when plain wheel is scrollback)
        scene.orbit(d_radius=(-0.1 if btn == 64 else 0.1)
                    * scene._orbit["radius"])
        return
    if btn == 0 and pressed:            # left press or drag
        if motion and "x" in drag:
            # one terminal cell = two pixels vertically (half blocks),
            # so d_phi per row is ~2x d_theta per column
            scene.orbit(d_theta=0.04 * (x - drag["x"]),
                        d_phi=0.08 * (drag["y"] - y))
        drag["x"], drag["y"] = x, y
    elif not pressed:
        drag.clear()


def handle_key(scene, key: str):
    """Apply one key to a scene — the live-loop equivalent of the
    reference's mouse-orbit input + egui sliders (wgpu-bootstrap
    OrbitCamera::input consumed at cloth.rs:1497-1499; panel at
    cloth.rs:1383-1451). Returns 'quit', 'pause', or None.

    Bindings: arrows orbit, +/- zoom, g/G gravity down/up 10%,
    t/T time-scale, l/L light azimuth, u/U i/I o/O light position X/Y/Z
    -/+ (the reference's per-axis Light X/Y/Z sliders,
    cloth.rs:1400-1402), s/S shininess, k/K specular ks,
    x specular toggle, d/D speed damping, r/R particle radius (resets the
    cloth, like the reference's slider), space pause, q quit."""
    if key == "left":
        scene.orbit(d_theta=-0.15)
    elif key == "right":
        scene.orbit(d_theta=0.15)
    elif key == "up":
        scene.orbit(d_phi=0.1)
    elif key == "down":
        scene.orbit(d_phi=-0.1)
    elif key in "+=":
        scene.orbit(d_radius=-0.1 * scene._orbit["radius"])
    elif key in "-_":
        scene.orbit(d_radius=0.1 * scene._orbit["radius"])
    elif key in "gG" and hasattr(scene, "set_gravity"):
        g = float(scene.params.gravity)
        scene.set_gravity(g * (1.1 if key == "G" else 1 / 1.1))
    elif key in "tT" and hasattr(scene, "set_time_scale"):
        s = float(scene.time_scale)
        scene.set_time_scale(s * (1.25 if key == "T" else 0.8))
    elif key in "lL" and hasattr(scene, "set_light"):
        # light azimuth: rotate position about y (globe.rs light sliders)
        x, y, z = scene.light.position
        a = 0.2 if key == "L" else -0.2
        ca, sa = np.cos(a), np.sin(a)
        scene.set_light(position=(ca * x + sa * z, y, -sa * x + ca * z))
    elif key in "uUiIoO" and hasattr(scene, "set_light"):
        # per-axis light position (Light X/Y/Z sliders, cloth.rs:1400-1402)
        pos = list(scene.light.position)
        axis = {"u": 0, "i": 1, "o": 2}[key.lower()]
        pos[axis] = float(pos[axis]) + (1.0 if key.isupper() else -1.0)
        scene.set_light(position=tuple(pos))
    elif key in "sS" and hasattr(scene, "set_light"):
        sh = float(scene.light.shininess)
        scene.set_light(shininess=float(np.clip(
            sh * (1.25 if key == "S" else 0.8), 1.0, 256.0)))
    elif key in "kK" and hasattr(scene, "set_light"):
        ks = float(scene.light.ks)
        scene.set_light(ks=float(np.clip(
            ks + (0.1 if key == "K" else -0.1), 0.0, 10.0)))
    elif key == "x" and hasattr(scene, "set_light"):
        scene.set_light(compute_specular=not scene.light.compute_specular)
    elif key in "dD" and hasattr(scene, "set_speed_damp"):
        damp = float(scene.params.speed_damp)
        scene.set_speed_damp(float(np.clip(
            damp * (1.02 if key == "D" else 1 / 1.02), 1e-4, 1.0)))
    elif key in "rR" and hasattr(scene, "set_particle_radius"):
        # resets state, exactly like the reference's radius slider
        # (cloth.rs:1427-1435)
        r = float(scene.params.particle_radius)
        scene.set_particle_radius(r * (1.1 if key == "R" else 1 / 1.1))
    elif key == " ":
        return "pause"
    elif key == "q":
        return "quit"
    return None


_HELP = ("drag orbit  wheel zoom  arrows orbit  +/- zoom  g/G gravity  t/T speed  l/L light  "
         "u/U i/I o/O light xyz  "
         "s/S shin  k/K ks  x spec  d/D damp  r/R radius  space pause  q quit")


def status_line(scene, paused: bool = False, help_text: bool = False) -> str:
    """One-line scene readout: fps + the reference's egui info labels
    (instance / spring / vertex counts, cloth.rs:1438-1448) when the scene
    exposes them."""
    parts = [f"fps {scene.clock.fps:5.1f}"]
    if hasattr(scene, "instance_count"):
        parts.append(f"inst {scene.instance_count}")
    if hasattr(scene, "spring_count"):
        parts.append(f"springs {scene.spring_count}")
    if hasattr(scene, "mesh") and hasattr(scene.mesh, "positions"):
        parts.append(f"verts {scene.mesh.positions.shape[0]}")
    out = "  ".join(parts)
    if paused:
        out += " [paused]"
    if help_text:
        out += f"  |  {_HELP}"
    return out


def live(scene, seconds: float = 5.0, fps: int = 10, size=(128, 128),
         max_cols: int = 64, interactive=None) -> None:
    """Interactive terminal viewer: runs the scene's update/render loop,
    streams ANSI frames in place, and (on a tty) reads non-blocking key
    input — orbit/zoom/params while watching, the headless stand-in for
    the reference's winit window + egui panel."""
    import contextlib
    import select
    import sys
    import time as _time

    if interactive is None:
        interactive = sys.stdin.isatty()

    @contextlib.contextmanager
    def _cbreak():
        if not interactive:
            yield
            return
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            # SGR mouse reporting: button-motion tracking (?1002) in the
            # unambiguous ?1006 encoding — drag-to-orbit + wheel zoom,
            # the reference's OrbitCamera mouse input (cloth.rs:1497-1499)
            sys.stdout.write("\x1b[?1002h\x1b[?1006h")
            sys.stdout.flush()
            yield
        finally:
            sys.stdout.write("\x1b[?1002l\x1b[?1006l")
            sys.stdout.flush()
            termios.tcsetattr(fd, termios.TCSADRAIN, old)

    pending = b""

    def _poll_events():
        nonlocal pending
        if not interactive:
            return []
        events = []
        while select.select([sys.stdin], [], [], 0)[0]:
            buf = os.read(sys.stdin.fileno(), 256)
            if not buf:
                break
            evs, pending = parse_events(pending + buf, return_rest=True)
            events.extend(evs)
        return events

    n = int(seconds * fps)
    paused = False
    drag = {}
    with _cbreak():
        for i in range(n):
            t0 = _time.time()
            for k in _poll_events():
                if isinstance(k, tuple):
                    handle_mouse(scene, k, drag)
                    continue
                act = handle_key(scene, k)
                if act == "pause":
                    paused = not paused
                elif act == "quit":
                    return
            if not paused:
                scene.update(1.0 / fps)
            frame = ansi_frame(scene.render(*size), max_cols)
            rows = frame.count("\n") + 1
            if i:
                sys.stdout.write(f"\x1b[{rows + 1}F")   # cursor back up
            status = status_line(scene, paused, help_text=interactive)
            sys.stdout.write(frame + f"\n{status}\x1b[K\n")
            sys.stdout.flush()
            _time.sleep(max(0.0, 1.0 / fps - (_time.time() - t0)))


def record(scene, seconds: float, fps: int = 30, size=(256, 256),
           path: Optional[str] = None, realtime_physics: bool = True):
    """Drive a scene's update/render loop headless and collect frames.

    ``scene``: any object with ``update(dt)`` and ``render(h, w)``.
    """
    frames = []
    n = int(seconds * fps)
    for _ in range(n):
        scene.update(1.0 / fps if realtime_physics else None)
        frames.append(scene.render(*size))
    if path:
        save_gif(frames, path, fps=fps)
    return frames
