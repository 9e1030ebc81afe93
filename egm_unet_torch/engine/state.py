"""Train state: the model (parameters and BatchNorm buffers), torch's SGD, the
schedule and the step count (port of ``egm_unet_tpu/engine/state.py``).

The reference optimises with ``SGD(lr=0.02, momentum=0.9,
weight_decay=1e-4)``.  The JAX package expresses it as the optax chain
``add_decayed_weights -> trace(momentum) -> scale_by_learning_rate``; that is
``torch.optim.SGD`` itself: weight decay enters the gradient before the
momentum buffer, the first step's buffer is that gradient (dampening 0), and
update k moves by ``schedule(k)`` times the buffer.  The schedule drives a
``LambdaLR`` over a base learning rate of 1, so the optimiser's rate is
``schedule(k)`` itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn as nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    lr_fn: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimiser update from the gradients in ``.grad``, then the
        schedule's next step.  A parameter of the optimiser that took no
        gradient gets a zero one, so that weight decay and momentum still
        move it, as optax moves every leaf; frozen parameters are not the
        optimiser's and stay as they are."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])
        # this run's schedule rates the next update, as the JAX state's
        # schedule(count) does, also where the run's length changed
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr_fn(self.step)


def sgd_torch(params, lr_schedule, momentum: float = 0.9,
              weight_decay: float = 1e-4):
    """(SGD, LambdaLR) with the semantics of the JAX package's ``sgd_torch``."""
    opt = torch.optim.SGD(params, lr=1.0, momentum=momentum, dampening=0.0,
                          weight_decay=weight_decay, nesterov=False)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule)


def create_train_state(model: nn.Module, lr_schedule, momentum: float = 0.9,
                       weight_decay: float = 1e-4) -> TrainState:
    """The state of a run starting from ``model``'s weights, on its device."""
    opt, sched = sgd_torch(model.parameters(), lr_schedule, momentum, weight_decay)
    return TrainState(model=model, optimizer=opt, scheduler=sched, lr_fn=lr_schedule)
