"""The raster kernels' share of their roofline (``ops/raster_kernel.py`` →
``sphere_raster.cu``, K2/K3 with their work list: ``plan_*`` and
``sphere_raster_*``), a launch a chunk of worlds.

The frozen count of one launch on B worlds of N spheres at H x W: bytes
B * (32 H W + 32 N) (rays in, 12 B a pixel; the nearest hit's distance,
winner and centre out, 20 B a pixel; the sorted table and the rectangles
in, 32 B a sphere); operations OPS_RAY_SPHERE for every (pixel, sphere)
pair whose pixel lies in the sphere's conservative screen rectangle
(columns and rows within R = 1.5 r_px + 2 of its projected centre, r_px
its radius in pixels at its near depth stretched by the worst corner's
1 / cos²; the whole frame for a sphere that reach does not keep inside one
8-row tile, or that is not in front of the near plane). The spheres are
the traced frames' cloth positions seen by their worlds' cameras."""

import math

import torch

from port_bench.metrics.common import kernel_us, roofline_pct
from port_bench.peaks import bound_s
from port_bench.reference.render import cameras

# fp32 operations of a (pixel, sphere) ray test: b 5, disc 2, t 3, tests 3
OPS_RAY_SPHERE = 13
TILE_ROWS = 8
KERNELS = r"sphere_raster|plan_(count|scan|runs|fill)"


def rect_pairs(centers, rot, eye, r, znear, tan_half, aspect, h, w):
    """Pixels in the spheres' conservative rectangles, summed."""
    oc = centers - eye[:, None, :]
    cv = torch.einsum("bij,bnj->bni", rot, oc)
    depth = -cv[..., 2]
    safe = depth > (znear + r)
    d = torch.where(safe, depth, torch.ones_like(depth))
    col = ((cv[..., 0] / d) / (tan_half * aspect) + 1.0) * 0.5 * w - 0.5
    row = (1.0 - (cv[..., 1] / d) / tan_half) * 0.5 * h - 0.5
    elong = 1.0 + tan_half * tan_half * (1.0 + aspect * aspect)
    r_px = elong * r / (d - r) * max(h / (2.0 * tan_half),
                                     w / (2.0 * tan_half * aspect))
    reach = 1.5 * r_px + 2.0
    fits = safe & (reach < TILE_ROWS)

    def span(c, size):
        lo = torch.clamp(torch.floor(c - reach), -1.0, size)
        hi = torch.clamp(torch.ceil(c + reach), -1.0, size)
        lo = torch.where(fits, lo, torch.zeros_like(lo))
        hi = torch.where(fits, hi, torch.full_like(hi, size - 1.0))
        return (torch.clamp(hi, max=size - 1.0) - torch.clamp(lo, min=0.0)
                + 1.0).clamp_min(0.0)

    return float((span(col, w).double() * span(row, h).double()).sum())


def read(ctx):
    tr, wk, cfg = ctx["trace"], ctx["work"], ctx["config"]
    device_us = kernel_us(tr, KERNELS)
    if not wk.get("positions") or device_us <= 0:
        return None
    h, w = wk["frame"]
    cam = cfg["camera"]
    rot, _, eye = cameras(wk["theta"], wk["phi"], wk["radius"], cam)
    tan_half = math.tan(cam["fovy_deg"] * math.pi / 360.0)
    r = cfg["cloth"]["particle_radius"]
    total = 0.0
    for pos in wk["positions"][-tr.units:]:
        dev = pos.device
        b = pos.shape[0]
        centers = pos.reshape(b, 3, -1).transpose(1, 2)
        n = centers.shape[1]
        for i0 in range(0, b, wk["chunk"]):
            i1 = min(b, i0 + wk["chunk"])
            pairs = rect_pairs(centers[i0:i1], rot[i0:i1].to(dev),
                               eye[i0:i1].to(dev), r, cam["znear"], tan_half,
                               1.0, h, w)
            total += bound_s((i1 - i0) * (32.0 * h * w + 32.0 * n),
                             OPS_RAY_SPHERE * pairs)
    return roofline_pct(total, device_us)
