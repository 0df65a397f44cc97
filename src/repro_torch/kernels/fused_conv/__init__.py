"""The fused conv-pyramid kernel family of the port.

* :mod:`.fused_conv` — the CUDA launch wrapper
  (:func:`~.fused_conv.fused_pyramid_kernel`), its launch counters and its
  plain PyTorch version (:func:`~.fused_conv.fused_pyramid_plain`);
* :mod:`.ops` — padding, regime/knob resolution and budget checks
  (:func:`~.ops.fused_pyramid`, :func:`~.ops.fused_pyramid_chain`);
* :mod:`.ref` — the layer-by-layer oracle.
"""
