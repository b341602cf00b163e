"""Seconds of the scene build: the program's SceneBuilder.build (BVH, kernel
records, envmap tables, upload), the benchmark's span around it."""


def read(run):
    if not any(name == "scene_build" for name, _, _ in run.ctx.spans):
        return None
    return run.ctx.span_seconds("scene_build")
