"""Plain references of the benchmark's configurations (no program code)."""
