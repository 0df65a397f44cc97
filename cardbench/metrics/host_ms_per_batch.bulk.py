from cardbench.program_trace import host_ms_per_batch as read  # noqa: F401
