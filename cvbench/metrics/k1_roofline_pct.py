"""``k1_roofline_pct``: K1, the Gaussian heatmap splat
(``gaussian_splat_kernel``), against its roofline in the traced stretch: each
call's bound is the bytes it needs at the HBM bandwidth (the map written
once, the objects read once: ``reference/kernels.py::k1_bound_s`` at the
cell's shapes), over the device time of its kernels, in %. None when the
stretch holds no K1 kernel."""

from cvbench.reference.kernels import k1_bound_s

KERNEL = "gaussian_splat_kernel"


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("k1_shape"):
        return None
    hits = [v for name, v in ctx.trace.kernels.items() if KERNEL in name]
    if not hits:
        return None
    n, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    return 100.0 * n * k1_bound_s(*ctx.counters["k1_shape"]) / seconds
