"""Dense Adam exactly as the JAX package writes it.

``paddle_tpu.optimizer.Adam`` (functional init/update over a parameter
tree) on a dict of tensors with an explicit step counter::

    bc = 1 - beta**(step + 1)
    m' = beta1*m + (1-beta1)*g;  v' = beta2*v + (1-beta2)*g*g
    p' = p - lr * (m'/bc1) / (sqrt(v'/bc2) + eps)

Not ``torch.optim.Adam``, whose algebra rounds differently. The step
counter is a 0-dim int64 tensor on the parameters' device, so a step
needs no host round-trip.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["Adam"]

Params = Dict[str, torch.Tensor]


class Adam:
    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8) -> None:
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2, self.epsilon = float(beta1), float(beta2), float(epsilon)

    def init(self, params: Params) -> dict:
        """{"step": 0-dim int64, "m": {name: zeros}, "v": {name: zeros}}."""
        dev = next(iter(params.values())).device
        return {"step": torch.zeros((), dtype=torch.int64, device=dev),
                "m": {k: torch.zeros_like(p) for k, p in params.items()},
                "v": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Params, opt_state: dict, params: Params) -> Tuple[Params, dict]:
        """→ (new_params, new_opt_state); inputs are not modified."""
        step = opt_state["step"]
        t = (step + 1).to(torch.float32)
        bc1 = 1 - torch.pow(self.beta1, t)
        bc2 = 1 - torch.pow(self.beta2, t)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            g = grads[k]
            m = self.beta1 * opt_state["m"][k] + (1 - self.beta1) * g
            v = self.beta2 * opt_state["v"][k] + (1 - self.beta2) * (g * g)
            m_hat = m / bc1
            v_hat = v / bc2
            new_p[k] = p - self.learning_rate * m_hat / (torch.sqrt(v_hat) + self.epsilon)
            new_m[k], new_v[k] = m, v
        return new_p, {"step": step + 1, "m": new_m, "v": new_v}
