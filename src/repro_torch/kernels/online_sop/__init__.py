"""The digit-serial SOP + END kernel family of the port (the paper's WPU
with Early Negative Detection, Algorithms 1-2).

* :mod:`.online_sop` — the CUDA launch wrapper
  (:func:`~.online_sop.online_sop_end_kernel`), its launch counter and its
  plain PyTorch version (:func:`~.online_sop.online_sop_end_plain`);
* :mod:`.ops` — :func:`~.ops.online_sop_end`, the public entry over any
  batch dims;
* :mod:`.ref` — the einsum and cumsum oracle.
"""

from .ops import online_sop_end

__all__ = ["online_sop_end"]
