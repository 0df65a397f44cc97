"""The language-model scaffold of the port, cut to the dense (GQA or MLA
attention), MoE, hybrid and SSM families.

* :mod:`.params` — ``P`` specs, tree walking, seeded init;
* :mod:`.layers` — RMSNorm, SwiGLU, RoPE, dense and chunked attention, the
  GQA block and multi-head latent attention;
* :mod:`.moe` — top-k routing, capacity dispatch and combine, the expert
  SwiGLU and the MoE FFN;
* :mod:`.ssm` — Mamba-2: chunked SSD, the decode recurrence, the causal
  conv and the mixer (whose prefill runs the SSD chunk-scan kernel);
* :mod:`.blocks` — ``LayerCtx`` and ``dense_layer``, ``moe_layer``,
  ``ssm_layer``, ``hybrid_layer``;
* :mod:`.model` — param specs, init, the forward over the layer stack;
* :mod:`.serving` — caches and the decode step.
"""
