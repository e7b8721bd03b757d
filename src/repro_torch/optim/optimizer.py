"""AdamW + schedules over the port's parameter trees, as the reference's
``optim/optimizer.py``.

Optimizer state lives in f32 whatever the param dtype (bf16-safe master
moments); weight decay is decoupled.  ``schedule`` is linear warmup then
cosine decay to ``min_lr_ratio``.  The step count is an int32 tensor on the
params' device, so a step never waits for the device.

Weight decay follows the reference's layout, not the port's: the reference
decays a leaf of rank >= 2 and leaves the rest alone ("no decay on norms /
biases"), and it stacks the decoder's blocks on a leading axis, so a
block's norm scale, 1-D here, is 2-D there and decayed; only
``final_norm`` and the remainder layers' norms escape.  The rank is
therefore the leaf's rank in the reference's layout
(:func:`repro_torch.tree.reference_ndims`).

The update rounds as the reference's does: ``u`` in f32, cast to the
param's dtype, then added in that dtype.

``update`` is one step span, ``optim.update`` (:func:`repro_torch.spans.step`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch import tree as tree_lib


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1

    # ------------------------------------------------------------------ #
    def init(self, params: Any) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        flat = tree_lib.leaves(params)
        device = flat[0].device if flat else None
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_lib.tree_map(zeros, params),
            nu=tree_lib.tree_map(zeros, params),
        )

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        frac = torch.clamp(
            (step - self.warmup_steps)
            / max(self.total_steps - self.warmup_steps, 1),
            0.0,
            1.0,
        )
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        decay = self.min_lr_ratio + (1 - self.min_lr_ratio) * cos
        return self.learning_rate * warm * decay

    def update(
        self, grads: Any, state: AdamWState, params: Any
    ) -> Tuple[Any, AdamWState]:
        with spans.step("optim.update", device=state.step.device):
            return self._update(grads, state, params)

    def _update(
        self, grads: Any, state: AdamWState, params: Any
    ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        flat_g = tree_lib.leaves(grads)
        if self.grad_clip is not None:
            gnorm = global_norm(grads)
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
            flat_g = [g * scale.to(g.dtype) for g in flat_g]

        b1, b2 = self.b1, self.b2
        mu = [
            b1 * m + (1 - b1) * g.float()
            for m, g in zip(tree_lib.leaves(state.mu), flat_g)
        ]
        nu = [
            b2 * v + (1 - b2) * torch.square(g.float())
            for v, g in zip(tree_lib.leaves(state.nu), flat_g)
        ]
        t = step.to(torch.float32)
        mu_hat_scale = 1.0 / (1 - b1**t)
        nu_hat_scale = 1.0 / (1 - b2**t)
        lr = self.schedule(step)

        flat_p = tree_lib.leaves(params)
        new_p = []
        for p, m, v, ndim in zip(flat_p, mu, nu, tree_lib.reference_ndims(params)):
            u = (m * mu_hat_scale) / (torch.sqrt(v * nu_hat_scale) + self.eps)
            if self.weight_decay and ndim >= 2:  # no decay on norms/biases
                u = u + self.weight_decay * p.float()
            new_p.append(p + (-lr * u).to(p.dtype))
        return tree_lib.unflatten(params, new_p), AdamWState(
            step=step,
            mu=tree_lib.unflatten(state.mu, mu),
            nu=tree_lib.unflatten(state.nu, nu),
        )


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""

    return torch.sqrt(
        sum(torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree))
    )
