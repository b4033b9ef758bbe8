"""What several metric readers share."""

from __future__ import annotations


def mfu_pct(ctx):
    """Frames completed in the window times the reference's FLOPs per
    frame, over the window, the cards and each card's dense bf16 peak, in
    %; None on a card whose peak the table lacks. Refuses a rate over the
    peak."""
    c = ctx.counters
    if ctx.peak is None or not c.get("frames"):
        return None
    rate = c["frames"] * c["flops_per_frame"] / c["window_s"] / c.get("cards", 1)
    if rate > ctx.peak:
        raise RuntimeError(f"impossible measurement: {rate / 1e12:.1f} TFLOP/s over the "
                           f"card's peak {ctx.peak / 1e12:.0f}")
    return 100.0 * rate / ctx.peak


def idle_pct(ctx):
    """The share of the traced stretch in which no device operation ran."""
    return None if ctx.trace is None else ctx.trace.idle_pct
