from cardbench.metrics._shares import images_per_batch as read  # noqa: F401
