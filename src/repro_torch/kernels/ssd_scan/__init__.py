"""The Mamba-2 SSD chunk-scan kernel family of the port.

* :mod:`.ssd_scan` — the CUDA launch wrapper
  (:func:`~.ssd_scan.ssd_scan_kernel`), its launch counter and its plain
  PyTorch version (:func:`~.ssd_scan.ssd_scan_plain`);
* :mod:`.ops` — :func:`~.ops.ssd_scan`, the public entry that pads the
  sequence to a chunk multiple and runs the kernel inside
  :class:`~.ops.SsdScan`, an autograd Function with a plain backward;
* :mod:`.ref` — the token-by-token recurrence oracle.

The package exports no names: its module :mod:`.ssd_scan` and the function
:func:`.ops.ssd_scan` share the package's name.
"""
