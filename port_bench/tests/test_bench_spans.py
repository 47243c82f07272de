"""The program's spans in a trace (``trace_spans.read``) and the span
metric readers (``metrics/spans.py``) on a small stored trace
(``data/trace_spans.json``: two units, the first skipped with a span and a
sync of its own; in the kept unit a scene call around the packing and
the launches' issue on thread 1, a segment's backward around the
adjoint's issue on thread 2, a render with its shade and composite on
thread 1; syncs inside a span on its thread, outside any span, and on a
thread with no span open while another has one; idle gaps inside and
outside the spans), and on ``data/trace_small.json``."""

import os

import pytest

from port_bench import harness, trace, trace_spans

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def _ctx(name):
    path = os.path.join(DATA, name)
    tr = trace.read(path)
    return {"trace": tr, "spans": trace_spans.read(path, tr), "work": {}}


@pytest.fixture
def ctx():
    return _ctx("trace_spans.json")


def test_read_keeps_the_kept_units_spans_on_every_thread(ctx):
    sp = ctx["spans"]
    assert sp.units == 1
    assert [(s.name, s.tid) for s in sp.spans] == [
        ("scene.simulate", 1), ("cloth.pack", 1), ("cloth.issue", 1),
        ("grad.segment.backward", 2), ("grad.adjoint.issue", 2),
        ("datagen.render", 1), ("render.shade", 1), ("render.composite", 1)]
    assert "cudaEventSynchronize" not in [r.name for r in sp.runtime]
    assert len(sp.ops) == len(ctx["trace"].ops) == 9
    assert sp.idle == [(100, 118), (120, 145), (205, 222), (240, 276),
                       (284, 286), (292, 296), (299, 300)]


@pytest.mark.parametrize("name", ["trace_spans.json", "trace_small.json"])
def test_idle_intervals_sum_to_the_idle_time(name):
    c = _ctx(name)
    tr = c["trace"]
    assert sum(b - a for a, b in c["spans"].idle) == pytest.approx(
        tr.window_us - tr.busy_us)


@pytest.mark.parametrize("name,value", [
    ("scene.idle_ms_per_unit", 0.025),
    ("grad.idle_ms_per_unit", 0.036),
    ("render.idle_ms_per_frame", 0.002),
    ("codec.idle_ms_per_frame", None),
    ("datagen.step.idle_ms_per_frame", None),
    ("datagen.fetch.idle_ms_per_frame", None),
    ("idle_outside_program_ms_per_unit.sim", 0.040),
    ("idle_outside_program_ms_per_unit.grad", 0.040),
    ("host_syncs_per_unit.datagen", 2.0),
    ("k1.issue_us_per_launch.sim", 15.0),
    ("k1.issue_us_per_launch.grad", 15.0),
    ("render.shade.device_ms_per_frame", 0.008),
    ("render.composite.device_ms_per_frame", 0.006),
])
def test_span_readers(ctx, name, value):
    got = harness.load_metric(name).read(ctx)
    assert got == (None if value is None else pytest.approx(value))


def test_layers_and_outside_partition_the_idle_time(ctx):
    tr = ctx["trace"]
    names = ["scene.idle_ms_per_unit", "grad.idle_ms_per_unit",
             "render.idle_ms_per_frame", "idle_outside_program_ms_per_unit"]
    total = sum(harness.load_metric(n).read(ctx) for n in names)
    assert total == pytest.approx((tr.window_us - tr.busy_us) * 1e-3)


@pytest.mark.parametrize("name", [
    "scene.idle_ms_per_unit", "grad.idle_ms_per_unit",
    "idle_outside_program_ms_per_unit.sim", "host_syncs_per_unit.sim",
    "k1.issue_us_per_launch.sim", "render.shade.device_ms_per_frame"])
def test_span_readers_read_nothing_without_spans(ctx, name):
    """A program without the spans (or a trace read by the harness alone,
    which hands its readers no spans) gives no number and raises
    nothing."""
    bare = ctx["spans"]._replace(spans=[])
    assert harness.load_metric(name).read({**ctx, "spans": bare}) is None
    assert harness.load_metric(name).read({"trace": ctx["trace"]}) is None


def test_small_trace_reads_as_before():
    """The datagen ranges of ``trace_small.json`` are program spans: its
    render and codec idle and the outside partition its idle time."""
    c = _ctx("trace_small.json")
    tr = c["trace"]
    parts = [harness.load_metric(n).read(c) for n in (
        "render.idle_ms_per_frame", "codec.idle_ms_per_frame",
        "idle_outside_program_ms_per_unit.datagen")]
    assert sum(parts) == pytest.approx((tr.window_us - tr.busy_us) * 1e-3)
    assert harness.load_metric("render.device_ms_per_frame").read(c) == \
        pytest.approx(0.010)
