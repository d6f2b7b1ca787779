from portbench.metrics._common import optimizer_roofline as read  # noqa: F401
