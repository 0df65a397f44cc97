from cardbench.metrics._shares import idle_share as read  # noqa: F401
