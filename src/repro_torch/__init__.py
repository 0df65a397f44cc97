"""USEFUSE fused-pyramid CNN inference on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the reference package ``repro`` (JAX/Pallas on a TPU),
kept beside it with the same layout and names:

* :mod:`repro_torch.core` — fusion planning, the tile-program compiler,
  the cycle model, the tile-level executor oracle, :func:`resolve_device`;
* :mod:`repro_torch.kernels.fused_conv` — the fused-pyramid kernel (CUDA C++
  for ``sm_90a`` under ``csrc/``), its plain PyTorch version, and the
  padding/budget wrappers;
* :mod:`repro_torch.net` — the graph zoo, the memory-aware auto-partitioner
  and the plan-driven ``run_network``;
* :mod:`repro_torch.obs`, :mod:`repro_torch.robust` — tracing and the typed
  errors;
* :mod:`repro_torch.interop` — carries the reference's numpy params across.

The package imports ``torch`` and numpy, never ``jax`` and never anything
under ``repro``: the reference's ``repro/core/__init__.py`` imports jax, so
even its pure-Python modules would pull jax in, and the port keeps its own
copies of them instead.  Activations are NHWC and conv weights HWIO
``(K, K, Cin, Cout)`` at every public function, as in the reference.
"""
