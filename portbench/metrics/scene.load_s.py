"""scene.load_s: the benchmark's clock around handing the scene to the port
(``gltf.load_scene`` or ``bridge.scene_from_numpy``) and constructing the
``Renderer``."""


def read(ctx):
    return ctx.scene_load_s
