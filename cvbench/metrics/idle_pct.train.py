"""``idle_pct.train``: the share of the traced stretch of training in which
the device ran no operation, in %."""

from cvbench.metrics._common import idle_pct as read  # noqa: F401
