"""The Mamba-2 SSD chunk-scan kernel family of the port.

* :mod:`.ssd_scan` — the CUDA launch wrappers of the scan
  (:func:`~.ssd_scan.ssd_scan_kernel`) and of its backward
  (:func:`~.ssd_scan.ssd_scan_bwd_kernel`), their launch counters and
  their plain PyTorch versions (:func:`~.ssd_scan.ssd_scan_plain`,
  :func:`~.ssd_scan.ssd_scan_bwd_plain`);
* :mod:`.ops` — :func:`~.ops.ssd_scan`, the public entry that pads the
  sequence to a chunk multiple and runs the kernel inside
  :class:`~.ops.SsdScan`, an autograd Function whose backward is the
  backward kernel;
* :mod:`.ref` — the token-by-token recurrence oracle.

The package exports no names: its module :mod:`.ssd_scan` and the function
:func:`.ops.ssd_scan` share the package's name.
"""
