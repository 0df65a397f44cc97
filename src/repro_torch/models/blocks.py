"""Per-family layer bodies.

The port of the reference's ``repro.models.blocks``, cut to the SSM family:
:func:`ssm_layer` has the signature ``(cfg, p, x, cache) -> (x,
new_cache)``, and :mod:`repro_torch.models.model` loops it over stacked
params.  The reference's ``LayerCtx`` (mode, decode position, attention
switches), its ``_norm`` dispatch and the per-layer aux loss have no reader
in this family and wait for the families that read them.
"""

from __future__ import annotations

from .layers import rms_norm
from .ssm import mamba2_mixer


def ssm_layer(cfg, p, x, cache=None):
    """Mamba-2 block: rmsnorm -> mixer -> residual (no separate FFN).
    ``cache`` is ``None`` in prefill and the layer's SSM cache in decode."""
    h, new_cache = mamba2_mixer(
        p["mixer"],
        rms_norm(x, p["norm"]),
        n_heads=cfg.ssm_heads,
        head_dim=cfg.ssm_head_dim,
        state_dim=cfg.ssm_state,
        conv_dim=cfg.ssm_conv,
        chunk=cfg.ssd_chunk,
        ssm_cache=cache,
    )
    return x + h, new_cache
