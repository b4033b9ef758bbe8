"""``net_passes_per_call.infer``: the model's network passes (DMDS: depth and
motion) over the window's pipeline calls, from the runner's ``net_passes``
and ``calls`` counters (the model class's ``depth_passes`` and
``motion_passes`` deltas; a graph's replay adds what its capture counted).
None where the runner or the program counts no passes."""


def read(ctx):
    c = ctx.counters
    if c.get("net_passes") is None or not c.get("calls"):
        return None
    return c["net_passes"] / c["calls"]
