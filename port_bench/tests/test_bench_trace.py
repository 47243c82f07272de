"""The trace reader and the per-layer metric readers on a small stored
trace (``data/trace_small.json``: two units, the first skipped; a render
range with a raster kernel and an elementwise one, a codec range with a
matrix product, a copy outside any range, a kernel of the harness's own
``bench.work`` range, left out, and one launch whose device record is
missing)."""

import os

import pytest

from port_bench import harness, trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "trace_small.json")


@pytest.fixture
def tr():
    return trace.read(DATA)


def test_read(tr):
    assert tr.units == 1
    assert [o.owner for o in tr.ops] == ["datagen.render", "datagen.render",
                                         "datagen.codec", ""]
    assert tr.window_us == 120
    assert tr.busy_us == 75
    assert (tr.missing, tr.launched) == (1, 5)
    assert tr.gaps == [("host idle", 20), ("aten::copy_", 15),
                       ("datagen.codec", 10)]
    assert trace.top_ops(tr, 1)[0][1] == pytest.approx(30e-6)


@pytest.mark.parametrize("name,value", [
    ("datagen.device_ops_per_frame", 4.0),
    ("render.device_ms_per_frame", 0.010),
    ("codec.device_ms_per_frame", 0.015),
    ("device_idle_share.datagen", 0.375),
    ("device_idle_share.sim", 0.375),
    ("device_idle_share.grad", 0.375),
])
def test_readers(tr, name, value):
    got = harness.load_metric(name).read({"trace": tr, "work": {}})
    assert got == pytest.approx(value)


@pytest.mark.parametrize("name", ["k5r_roofline", "adjoint_roofline",
                                  "k1_roofline.sim", "k1_roofline.grad",
                                  "raster_roofline"])
def test_roofline_without_its_kernel_reads_nothing(tr, name):
    work = {"grid": (60, 60), "worlds": 8, "chunk": 4, "steps": 24,
            "positions": [], "frame": (32, 32)}
    ctx = {"trace": tr._replace(ops=[o for o in tr.ops
                                     if "raster" not in o.name]),
           "work": work, "config": {}}
    assert harness.load_metric(name).read(ctx) is None


def test_variants_share_their_base_reader():
    assert harness.load_metric("device_idle_share.sim").__file__ == \
        harness.load_metric("device_idle_share.grad").__file__
    assert harness.load_metric("k1_roofline.grad").__file__.endswith(
        "k1_roofline.py")


def test_trace_that_keeps_losing_records_fails(tr, monkeypatch):
    """A trace in which some launch has no device record, on every try,
    gives no per-layer metrics: the run ends without a result."""
    import torch

    class Cell:
        def units(self, traced=False):
            while True:
                yield 0.0, 0.0

    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(trace, "read", lambda path, skip=1: tr)
    assert tr.missing
    with pytest.raises(harness.IncompleteTrace):
        harness.traced(Cell(), 1)
    monkeypatch.setattr(trace, "read",
                        lambda path, skip=1: tr._replace(missing=0))
    assert harness.traced(Cell(), 1).missing == 0
