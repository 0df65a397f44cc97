"""The port's deterministic synthetic token pipeline (:mod:`.pipeline`)."""
