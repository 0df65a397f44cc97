from cardbench.program_trace import idle_under_host_work as read  # noqa: F401
