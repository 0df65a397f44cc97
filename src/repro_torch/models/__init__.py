"""The language models of the port: every family of the reference (dense
with GQA or MLA attention, MoE, hybrid, SSM, VLM, encoder-decoder).

* :mod:`.params` — ``P`` specs, tree walking, seeded init;
* :mod:`.layers` — RMSNorm, SwiGLU, RoPE, dense and chunked attention, the
  GQA block and multi-head latent attention;
* :mod:`.moe` — top-k routing, capacity dispatch and combine, the expert
  SwiGLU and the MoE FFN;
* :mod:`.ssm` — Mamba-2: chunked SSD, the decode recurrence, the causal
  conv and the mixer (whose prefill runs the SSD chunk-scan kernel);
* :mod:`.blocks` — ``LayerCtx`` and ``dense_layer``, ``moe_layer``,
  ``ssm_layer``, ``hybrid_layer``, ``cross_attn_block``;
* :mod:`.model` — param specs, init, the forward over the layer stack,
  remat, ``chunked_ce`` and ``lm_loss``;
* :mod:`.serving` — caches and the decode step.
"""
