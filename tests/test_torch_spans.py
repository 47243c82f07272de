"""The port's spans (``utils/profiling.span``): a shared no-op without a
profiler; under ``torch.profiler`` a range at each layer boundary, nested
as the calls are (the scene around the parameters' packing, the gradient's
forward around its segments, a segment's backward on the thread that runs
it, the render's split, the codec), with the ranges that the benchmark
already reads kept under their names. The last test needs a card: the
launches of K1 and of the adjoint fall inside the spans of their issue.

The file imports no jax, so its card test runs with ``--noconftest``:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py -q
"""

import json

import pytest
import torch

from wgpu_physics_engine_torch.core import config as cfg
from wgpu_physics_engine_torch.core import state as st
from wgpu_physics_engine_torch.models import cloth, granular, scenes
from wgpu_physics_engine_torch.ops import cloth_grad_kernel, cloth_kernel
from wgpu_physics_engine_torch.parallel import datagen, mesh
from wgpu_physics_engine_torch.utils import profiling

DT = 1.0 / 480.0


def _events(fn, tmp_path, cuda=False):
    """The complete events of a Chrome trace of ``fn()``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        if cuda:
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _spans(events, name):
    return [e for e in events
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _inside(inner, outer):
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_span_is_a_shared_noop_unless_a_profiler_records(tmp_path):
    a, b = profiling.span("scene.simulate"), profiling.span("cloth.pack")
    assert a is b and not isinstance(a, torch.profiler.record_function)
    opened = []

    def run():
        opened.append(profiling.span("scene.simulate"))
        with opened[0]:
            torch.ones(4).sum()

    ev = _events(run, tmp_path)
    assert isinstance(opened[0], torch.profiler.record_function)
    assert len(_spans(ev, "scene.simulate")) == 1
    assert profiling.span("scene.simulate") is a


@pytest.mark.parametrize("call,outer", [("simulate", "scene.simulate"),
                                        ("update", "scene.update")])
def test_scene_span_encloses_the_packing(tmp_path, call, outer):
    scene = scenes.ClothScene(config=cfg.ClothConfig(height=6, width=6),
                              use_kernel=True, device="cpu")
    step = (lambda: scene.simulate(4 * DT)) if call == "simulate" else (
        lambda: scene.update(1.0 / 60.0))
    ev = _events(step, tmp_path)
    (sc,) = _spans(ev, outer)
    (pack,) = _spans(ev, "cloth.pack")
    assert _inside(pack, sc)


def test_gradient_spans_and_the_backward_thread(tmp_path):
    c = cfg.ClothConfig(height=6, width=6)
    s = st.init_cloth_state(c, device="cpu")
    p = st.ClothParams.from_config(c, device="cpu")
    g = p.gravity.clone().requires_grad_(True)

    def run():
        out = cloth.multi_step_diff(s, p._replace(gravity=g), DT, 4,
                                    segment=2)
        out.pos[1].mean().backward()

    ev = _events(run, tmp_path)
    (fwd,) = _spans(ev, "grad.forward")
    segs = _spans(ev, "grad.segment.forward")
    assert len(segs) == 2 and all(_inside(x, fwd) for x in segs)
    assert _inside(_spans(ev, "cloth.pack")[0], fwd)
    back = _spans(ev, "grad.segment.backward")
    nodes = [e for e in ev if "_SegmentBackward" in e["name"]
             and e.get("cat") != "user_annotation"]
    assert len(back) == 2 and nodes
    assert all(any(_inside(x, n) for n in nodes) for x in back)
    assert g.grad is not None


def test_render_and_codec_spans(tmp_path):
    frames = []

    def run():
        frames.extend(datagen.generate_trajectory_dataset(
            cfg.ClothConfig(height=4, width=4, particle_radius=0.8,
                            cloth_size=16.0, center=(0.0, 14.0, 0.0)),
            n_worlds=2, n_frames=1, steps_per_frame=2, fb_size=(16, 128),
            generator=torch.Generator().manual_seed(3),
            randomize_cameras=True, codec_k=16, device="cpu"))

    ev = _events(run, tmp_path)
    assert len(frames) == 1
    (render,) = _spans(ev, "datagen.render")
    split = [_spans(ev, n) for n in ("render.bin", "render.raster",
                                     "render.shade", "render.composite")]
    assert all(len(x) == 1 and _inside(x[0], render) for x in split)
    starts = [x[0]["ts"] for x in split]
    assert starts == sorted(starts)
    (enc,) = _spans(ev, "codec.encode")
    assert _inside(enc, _spans(ev, "datagen.codec")[0])


def _run_range(name):
    """A small call of the path that opens range ``name``."""
    if name.startswith("datagen."):
        return lambda: list(datagen.generate_trajectory_dataset(
            cfg.ClothConfig(height=4, width=4), n_worlds=1, n_frames=1,
            steps_per_frame=1, fb_size=(16, 128), codec_k=16,
            device="cpu"))
    if name == "granular.rebuild":
        gc = granular.GranularConfig(num_particles=200, bounds=1.0,
                                     radius=0.05, pallas_block=128,
                                     pallas_slab=256, grid_capacity=16)
        s = granular.init_state(gc, device="cpu")
        return lambda: granular.rebuild(s.pos, s.vel, gc)
    if name == "mesh.halo_exchange":
        return lambda: mesh._exchange_halo([torch.zeros(3, 4, 5)] * 2)
    scene = scenes.ClothScene(config=cfg.ClothConfig(height=6, width=6),
                              self_collide=True, device="cpu")
    return lambda: scene.simulate(2 * DT)


@pytest.mark.parametrize("name", [
    "datagen.step", "datagen.render", "datagen.codec", "datagen.fetch",
    "granular.rebuild", "mesh.halo_exchange", "cloth.self_collide.rebuild"])
def test_existing_ranges_keep_their_names(tmp_path, name):
    assert _spans(_events(_run_range(name), tmp_path), name)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_launches_fall_inside_their_issue_spans(dev, tmp_path):
    """On a 64² cloth, every K1 launch (the forward's and the backward's
    trace) is made inside ``cloth.issue`` and every adjoint launch inside
    ``grad.adjoint.issue``, on the launching thread."""
    c = cfg.ClothConfig(height=64, width=64)
    s = st.init_cloth_state(c, device=dev)
    p = st.ClothParams.from_config(c, device=dev)
    g = p.gravity.clone().requires_grad_(True)

    def run():
        out = cloth.multi_step_diff(s, p._replace(gravity=g), DT, 8,
                                    segment=4)
        out.pos[1].mean().backward()

    run()                       # builds and loads the kernels
    k1, adj = cloth_kernel.LAUNCHES, cloth_grad_kernel.LAUNCHES
    ev = _events(run, tmp_path, cuda=True)
    k1 = cloth_kernel.LAUNCHES - k1
    adj = cloth_grad_kernel.LAUNCHES - adj
    kernels = {e["args"]["correlation"]: e["name"] for e in ev
               if e.get("cat") == "kernel"}
    launches = [e for e in ev if e.get("cat") == "cuda_runtime"
                and "Launch" in e["name"]
                and e.get("args", {}).get("correlation") in kernels]

    def launched(pattern):
        return [e for e in launches
                if pattern in kernels[e["args"]["correlation"]]]

    assert k1 > 8 and adj == 8
    for pattern, span, n in (("substep_kernel", "cloth.issue", k1),
                             ("vjp_substep", "grad.adjoint.issue", adj)):
        spans = _spans(ev, span)
        got = launched(pattern)
        assert len(got) == n
        assert all(any(_inside(x, sp) for sp in spans) for x in got)
