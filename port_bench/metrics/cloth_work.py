"""Frozen work counts of the cloth function and its adjoint, shared by the
cloth kernels' roofline metrics (``k5r_roofline``, ``k1_roofline``,
``adjoint_roofline``). They count the work the function
needs, whatever kernel computes it: each state byte once a call, every
substep's operations.
"""

from ..peaks import bound_s

# fp32 operations of the cloth substep: per spring edge 34 (the edge force
# 28: difference 3, squared length 5, sqrt and reciprocal 2, unit vector
# 3, stretch 1, relative velocity along it 8, force 3, components 3; and
# 6 to add it to both ends); per particle 82 (gravity 2, globe distance 7,
# normal 3, penalty 2 + 6, normal force 5, tangent 6, its length 7,
# friction 3 + 9, 1/m 1, velocity 12, position 6, projection 7 + 6).
OPS_EDGE = 34
OPS_PARTICLE = 82
# bytes a particle a cloth call: pos and vel read once and written once
CLOTH_BYTES = 48
# fp32 operations of the substep adjoint: per edge 116 (its forward force
# again, 34, and its adjoint 82); per particle 258 (the forward integration
# again, 82, and its adjoint 176); bytes a particle a substep 72 (the
# trajectory state read, the incoming cotangent read, the outgoing one
# written, 24 each).
OPS_VJP_EDGE = 116
OPS_VJP_PARTICLE = 258
VJP_BYTES = 72
# Spring families (dr, dc) of the cloth: structural, shear, bend.
FAMILIES = ((0, 1), (1, 0), (1, 1), (1, -1), (0, 2), (2, 0))


def cloth_edges(h: int, w: int) -> int:
    """Spring edges of an ``h x w`` grid."""
    return sum((h - dr) * (w - abs(dc)) for dr, dc in FAMILIES)


def cloth_call_s(h: int, w: int, worlds: int, substeps: int) -> float:
    """Bound of one cloth call of ``substeps`` on ``worlds`` grids: the
    state's bytes once, the operations of every substep."""
    ops = worlds * substeps * (OPS_EDGE * cloth_edges(h, w)
                               + OPS_PARTICLE * h * w)
    return bound_s(CLOTH_BYTES * worlds * h * w, ops)


def adjoint_substep_s(h: int, w: int) -> float:
    """Bound of one substep of the cloth adjoint on an ``h x w`` grid."""
    ops = OPS_VJP_EDGE * cloth_edges(h, w) + OPS_VJP_PARTICLE * h * w
    return bound_s(VJP_BYTES * h * w, ops)
