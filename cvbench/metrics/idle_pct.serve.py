"""``idle_pct.serve``: the share of the traced stretch in which the device ran no
operation (1 minus the union of kernel, copy and set intervals), in %."""

from cvbench.metrics._common import idle_pct as read  # noqa: F401
