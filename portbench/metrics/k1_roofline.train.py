from portbench.metrics._common import k1_roofline as read  # noqa: F401
