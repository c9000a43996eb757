"""World-space triangle gather (port of ``ops/bvh.py:world_triangles``).

The device LBVH build/refit of the reference is not ported yet (animated
scenes, ROADMAP item 15); static scenes build on the host (ops/bvh8.py).
"""
from __future__ import annotations


def world_triangles(world_pos, tri_vertex):
    """(V, 3) world positions + (T, 3) vertex ids -> (T, 3, 3) triangles."""
    t = tri_vertex.shape[0]
    return world_pos[tri_vertex.reshape(-1).long()].reshape(t, 3, 3)
