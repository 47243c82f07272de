"""The frozen work counts of the roofline metrics, pinned at the cells'
shapes to the bounds PERF.md states."""

import pytest
import torch

from port_bench import peaks
from port_bench.metrics import cloth_work
from port_bench import harness


def test_cloth_bounds_at_the_cells_shapes():
    # K5r: a call of 24 substeps on a chunk of 1,024 60x60 worlds
    assert cloth_work.cloth_call_s(60, 60, 1024, 24) / 24 * 1e3 == \
        pytest.approx(0.01543, rel=1e-3)
    # K1 on the 256² cloth: one substep a launch, bytes bound
    assert cloth_work.cloth_call_s(256, 256, 1, 1) * 1e3 == \
        pytest.approx(0.000939, rel=1e-3)
    # the adjoint: one substep at 256², bytes bound
    assert cloth_work.adjoint_substep_s(256, 256) * 1e3 == \
        pytest.approx(0.001408, rel=1e-3)
    assert cloth_work.cloth_edges(60, 60) == 21002


def test_raster_bound_at_the_datagen_launch():
    raster = harness.load_metric("raster_roofline")
    # a launch on 1,024 worlds of 3,600 spheres at 256x256 moves
    # 1024 * (32 * 65536 + 32 * 3600) bytes: 0.676 ms
    nbytes = 1024 * (32.0 * 256 * 256 + 32.0 * 3600)
    assert peaks.bound_s(nbytes, 0.0) * 1e3 == pytest.approx(0.67625,
                                                              rel=1e-4)
    assert raster.OPS_RAY_SPHERE == 13


def test_raster_rectangles():
    raster = harness.load_metric("raster_roofline")
    eye = torch.zeros((1, 3))
    rot = torch.eye(3)[None]
    kw = dict(r=0.1, znear=0.1, tan_half=1.0, aspect=1.0, h=64, w=64)
    # behind the camera: not binned, the whole frame
    behind = torch.tensor([[[0.0, 0.0, 5.0]]])
    assert raster.rect_pairs(behind, rot, eye, **kw) == 64 * 64
    # far ahead on the axis: a few pixels around the centre
    ahead = torch.tensor([[[0.0, 0.0, -50.0]]])
    n = raster.rect_pairs(ahead, rot, eye, **kw)
    assert 9 <= n <= 100
