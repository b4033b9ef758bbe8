"""``nccl_pct.train``: the share of rank 0's device busy time, in the traced
stretch, spent in kernels whose name starts with ``nccl`` (the gradient
all-reduce, the global BatchNorm and loss reductions), in %."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.busy_s:
        return None
    nccl = sum(s for name, (_, s) in ctx.trace.kernels.items() if name.startswith("nccl"))
    return 100.0 * nccl / ctx.trace.busy_s
