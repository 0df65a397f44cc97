"""The language-model scaffold of the port, cut to the SSM family.

* :mod:`.params` — ``P`` specs, tree walking, seeded init;
* :mod:`.layers` — ``rms_norm``;
* :mod:`.ssm` — Mamba-2: chunked SSD, the decode recurrence, the causal
  conv and the mixer (whose prefill runs the SSD chunk-scan kernel);
* :mod:`.blocks` — ``ssm_layer``;
* :mod:`.model` — param specs, init, the forward over the layer stack;
* :mod:`.serving` — caches and the decode step.
"""
