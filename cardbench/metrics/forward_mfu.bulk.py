from cardbench.metrics._shares import forward_mfu as read  # noqa: F401
