from cardbench.metrics._shares import launches_per_image as read  # noqa: F401
