"""mesh.moved_mb: megabytes (1e6 bytes) moved between the mesh's shards a
frame over the traced window: the growth of the program's ``Mesh.moved``
counter, summed over its kinds, over the window's frames; none without a
mesh."""


def read(ctx):
    moved = getattr(ctx, "moved_bytes", None)
    if not moved:
        return None
    total = sum(moved.values())
    return total / ctx.frames / 1e6 if total > 0 else None
