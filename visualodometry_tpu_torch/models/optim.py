"""Adam and the learning-rate schedules of the trainers, as optax computes them.

The JAX trainers use `optax.adam` with a constant rate,
`optax.linear_schedule` or `optax.cosine_decay_schedule`. This module
gives the same update in the same float32 order, so a step on the same
gradients moves the parameters as optax moves them:

    mu = (1 - b1) g + b1 mu;  nu = (1 - b2) g^2 + b2 nu;  t = count + 1
    p += -lr(count) * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)

The schedule is read at the count *before* the increment, as optax's
`scale_by_schedule` does. `torch.optim.Adam` arranges the same update in
another order (lr / (1 - b1^t) first), which differs from optax by a few
ulps a step.

The update runs as `torch._foreach_*` operations over all parameters, a
handful of launches a step whatever the parameter count.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax.linear_schedule: init_value to end_value over transition_steps,
    then end_value. float32 arithmetic, as jnp evaluates it."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule: init_value * ((1 - alpha) * 0.5 (1 +
    cos(pi t / T)) + alpha), t capped at T. float32 arithmetic."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cos = np.cos(np.float32(math.pi) * c / np.float32(decay_steps), dtype=np.float32)
        decay = np.float32(0.5) * (np.float32(1) + cos)
        decayed = np.float32(1 - alpha) * decay + np.float32(alpha)
        return float(np.float32(init_value) * decayed)

    return schedule


class Adam:
    """optax.adam(lr) over a list of parameters, updated in place.

    `lr` is a float or a schedule `count -> float`. `exp_avg` and
    `exp_avg_sq` are optax's `mu` and `nu`, one tensor a parameter; `count`
    is the number of steps taken.
    """

    def __init__(
        self,
        params,
        lr: float | Callable[[int], float],
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.params = [p for p in params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def learning_rate(self) -> float:
        """The rate the next step applies."""
        return self.lr(self.count) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        """Apply one update from `grads` (one tensor a parameter, in order)."""
        if len(grads) != len(self.params):
            raise ValueError(f"Adam.step: {len(grads)} gradients for {len(self.params)} params")
        b1, b2 = self.b1, self.b2
        lr = self.learning_rate()
        t = self.count + 1
        # optax: (1 - decay) * g + decay * moment, each product rounded
        torch._foreach_mul_(self.exp_avg, b1)
        torch._foreach_add_(self.exp_avg, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.exp_avg_sq, b2)
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1.0 - b2)
        torch._foreach_add_(self.exp_avg_sq, sq)
        # bias corrections in float32, as optax's `1 - decay ** count`
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        mu_hat = torch._foreach_div(self.exp_avg, bc1)
        denom = torch._foreach_div(self.exp_avg_sq, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(mu_hat, denom)
        torch._foreach_mul_(mu_hat, float(np.float32(-lr)))
        torch._foreach_add_(self.params, mu_hat)
        self.count = t
