from portbench.metrics._common import step_mfu as read  # noqa: F401
