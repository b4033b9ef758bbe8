"""``kernels_per_image.infer``: device kernels in the traced stretch over the
frames completed in it: the host's launches per frame."""


def read(ctx):
    n = ctx.counters.get("frames_in_stretch")
    return None if ctx.trace is None or not n else ctx.trace.n_kernels / n
