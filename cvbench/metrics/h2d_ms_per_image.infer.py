"""``h2d_ms_per_image.infer``: device milliseconds of the host-to-device copies
(the trace's ``Memcpy HtoD`` operations: the batch's planes and sizes) in
the traced stretch, over the frames completed in it. Read from the
breakdown's top ten device operations by time (``Trace.device_ops``): None
where no such copy is among them."""

PREFIX = "Memcpy HtoD"


def read(ctx):
    n = ctx.counters.get("frames_in_stretch")
    if ctx.trace is None or not n:
        return None
    hits = [s for name, s in ctx.trace.device_ops if name.startswith(PREFIX)]
    return 1e3 * sum(hits) / n if hits else None
