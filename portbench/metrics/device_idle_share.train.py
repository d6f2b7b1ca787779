from portbench.metrics._common import idle_share as read  # noqa: F401
