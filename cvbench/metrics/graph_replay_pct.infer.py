"""``graph_replay_pct.infer``: the share of the window's pipeline calls that
replayed a CUDA graph, in %: ``InferencePipeline.graph_counts``' deltas over
the window, replays over replays and eager calls (every reason). Below 100
the step fell back to eager launches. None where the runner passes no
``graph_counts``."""


def read(ctx):
    c = ctx.counters.get("graph_counts")
    if not c:
        return None
    calls = sum(v for k, v in c.items() if k != "captures")
    return 100.0 * c["replays"] / calls if calls else None
