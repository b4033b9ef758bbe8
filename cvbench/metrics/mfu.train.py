"""``mfu.train``: the training step's share of the card's dense bf16 peak, at
the forward and backward FLOPs the plain reference needs per image
(``reference/flops.py::train_flops``), times the images trained in the
window, over the window."""

from cvbench.metrics._common import mfu_pct as read  # noqa: F401
