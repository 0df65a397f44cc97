from cardbench.metrics._shares import conv_roofline as read  # noqa: F401
