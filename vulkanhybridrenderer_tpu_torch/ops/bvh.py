"""World-space triangle gather (port of ``ops/bvh.py:world_triangles``).

Every Renderer path traces the BVH8: static scenes build it on the host
(ops/bvh8.py) and animated ones refit it every frame (ops/bvh8.refit8).  The
reference's device LBVH (``build``, ``refit``, ``with_octant_links``), which
its renderer reaches only when the native SAH builder is missing, and the
binary-tree walk it feeds are not ported yet (ROADMAP).
"""
from __future__ import annotations


def world_triangles(world_pos, tri_vertex):
    """(V, 3) world positions + (T, 3) vertex ids -> (T, 3, 3) triangles."""
    t = tri_vertex.shape[0]
    return world_pos[tri_vertex.reshape(-1).long()].reshape(t, 3, 3)
