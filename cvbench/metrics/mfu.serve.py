"""``mfu.serve``: the model step's share of the card's dense bf16 peak, at the
FLOPs the plain reference needs per frame (``reference/flops.py``)."""

from cvbench.metrics._common import mfu_pct as read  # noqa: F401
