"""The training and serving control plane, pure Python: straggler
detection (:mod:`.straggler`), heartbeats and restart planning
(:mod:`.fault_tolerance`) and the continuous-batching scheduler
(:mod:`.scheduler`)."""
