"""``loader_ms_per_batch.train``: ``RecordLoader``'s host milliseconds per
batch over the window (read, JPEG decode and label assembly, its
``stage_seconds`` counters on its worker thread)."""


def read(ctx):
    return ctx.counters.get("loader_ms_per_batch")
