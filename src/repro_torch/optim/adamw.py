"""AdamW on trees of tensors.

The port of the reference's ``repro.optim.adamw``.  Moments are kept in a
configurable dtype (``cfg.moment_dtype``): float32 by default, bfloat16 for
the 480B-class MoE.  The update is the reference's: a float32 global-norm
clip over every gradient leaf, bias-corrected moments updated in float32,
weight decay on every leaf, the new params cast back to their own dtype.
Trees are nested dicts walked in sorted-key order
(:func:`repro_torch.models.params.tree_map`), the order ``jax.tree`` takes.
The update is functional, as the reference's: it returns new params and a
new state and leaves its arguments untouched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # scalar int32: updates taken
    mu: Any  # first moment tree
    nu: Any  # second moment tree


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: torch.dtype = torch.float32
    grad_clip: float = 1.0

    def init(self, params) -> AdamWState:
        """Zero moments in :attr:`moment_dtype` and step 0, each on its
        param's device."""
        first = leaves(params)[0]

        def zeros(p):
            return torch.zeros(p.shape, dtype=self.moment_dtype,
                               device=p.device)

        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=first.device),
            mu=tree_map(zeros, params),
            nu=tree_map(zeros, params),
        )

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, lr_scale=1.0):
        """One step: returns ``(new_params, new_state)``.  ``lr_scale``
        (a float or a float32 scalar tensor, the schedule's multiplier)
        scales :attr:`lr`."""
        f32 = torch.float32
        step = state.step + 1
        # global-norm clip in float32
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(f32)))
                               for g in leaves(grads)))
        clip = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = step.to(f32)
        b1c = 1.0 - torch.tensor(self.b1, dtype=f32) ** stepf
        b2c = 1.0 - torch.tensor(self.b2, dtype=f32) ** stepf
        lr = self.lr * torch.as_tensor(lr_scale, dtype=f32,
                                       device=stepf.device)

        def upd(g, m, v, p):
            g = g.to(f32) * clip
            m32 = m.to(f32) * self.b1 + g * (1 - self.b1)
            v32 = v.to(f32) * self.b2 + torch.square(g) * (1 - self.b2)
            mhat = m32 / b1c
            vhat = v32 / b2c
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            delta = delta + self.weight_decay * p.to(f32)
            new_p = p.to(f32) - lr * delta
            return (new_p.to(p.dtype), m32.to(self.moment_dtype),
                    v32.to(self.moment_dtype))

        out = [upd(*t) for t in zip(leaves(grads), leaves(state.mu),
                                    leaves(state.nu), leaves(params))]
        new_params, new_mu, new_nu = (tree_unflatten(params, part)
                                      for part in zip(*out))
        return new_params, AdamWState(step=step, mu=new_mu, nu=new_nu)
