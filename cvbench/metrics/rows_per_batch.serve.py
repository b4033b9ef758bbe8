"""``rows_per_batch.serve``: requests per dispatched batch of the
``DynamicBatcher`` (its ``n_requests`` and ``n_batches`` counters read at the
window's start and where the traced stretch starts: the profiler's start and
stop stall the batcher's thread, after which batches fill from the backlog)."""


def read(ctx):
    c = ctx.counters
    return c["requests"] / c["batches"] if c.get("batches") else None
