"""Host milliseconds of the scene build in set-up: the catalog's
``models/catalog.create_scene`` and ``models/scene.SceneBuilder.build``
(the native OBJ parser and Morton order under them), as the CLI calls
them. The job times the two calls itself."""


def install(ctx):
    return None


def value(ctx, state):
    return ctx.layer.get("scene_build_ms")
