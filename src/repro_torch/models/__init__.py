"""The language-model scaffold of the port, cut to the dense, hybrid and
SSM families.

* :mod:`.params` — ``P`` specs, tree walking, seeded init;
* :mod:`.layers` — RMSNorm, SwiGLU, RoPE, dense and chunked attention and
  the GQA block;
* :mod:`.ssm` — Mamba-2: chunked SSD, the decode recurrence, the causal
  conv and the mixer (whose prefill runs the SSD chunk-scan kernel);
* :mod:`.blocks` — ``LayerCtx`` and ``dense_layer``, ``ssm_layer``,
  ``hybrid_layer``;
* :mod:`.model` — param specs, init, the forward over the layer stack;
* :mod:`.serving` — caches and the decode step.
"""
