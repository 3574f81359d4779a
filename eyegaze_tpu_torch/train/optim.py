"""AdamW with global-norm clipping, LR schedules, per-group LRs and freezing.

Port of ``eyegaze_tpu/train/optim.py``, which chains optax's
``clip_by_global_norm`` and ``adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight
decay on every parameter).  Three points where PyTorch's stock tools would
differ from optax, and what this module does instead:

- Clipping: ``g`` when ``norm < max_norm``, else ``g / norm * max_norm``, as
  optax computes it (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
  norm).  The norm spans every parameter, frozen ones too, as the clip
  precedes the per-group transforms in the optax chain.
- Schedules are plain functions of the update count: update ``k`` (0-based)
  uses ``schedule(k)``, as optax's count does, set on each group before
  ``torch.optim.AdamW.step`` (``LambdaLR`` would be one step late).
- Groups: ``param_groups(name, param) -> group`` assigns each parameter; a
  group in ``group_lrs`` uses that LR (a float or a schedule), the others
  ``learning_rate``; a group in ``frozen_groups`` gets no update and no
  decay (``optax.set_to_zero``).

Under tensor parallelism (``parallel/tensor.py``) the parameters a rank
holds are its shards and the replicated rest.  The global norm is the full
arrays' (JAX's, ``eyegaze_tpu/train/trainer.py:108-109``): the squares of
the sharded gradients summed over the tp group, plus the replicated ones
counted once.  Otherwise tp would change the clip and every step after it.
AdamW runs on the shards unchanged; its moments, made at its first step,
are per shard.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]


def warmup_cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                           min_ratio: float = 0.0) -> Schedule:
    """Linear warmup from 0 then cosine decay to min_ratio*base_lr, stepped
    per batch (train_gaze_earlyfusion.py:93-118 semantics;
    ``optax.warmup_cosine_decay_schedule``)."""
    warmup = max(warmup_steps, 1)
    decay = max(total_steps, warmup_steps + 1) - warmup
    end = base_lr * min_ratio
    alpha = 0.0 if base_lr == 0.0 else end / base_lr

    def schedule(step: int) -> float:
        if step < warmup:
            return base_lr * step / warmup
        frac = min(step - warmup, decay) / decay
        return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    return schedule


def cosine_annealing_schedule(base_lr: float, total_epochs: int,
                              steps_per_epoch: int) -> Schedule:
    """torch CosineAnnealingLR(T_max=epochs) stepped per epoch: the LR is a
    function of the epoch index, constant within an epoch."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        frac = min(epoch / max(total_epochs, 1), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: Optional[float],
                         sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """Scales ``grads`` in place to a global norm of at most ``max_norm``
    (None: no clipping), in optax's form, without a host sync; returns the
    norm before clipping.  ``sharded`` marks the gradients that are a tp
    rank's shards (module docstring)."""
    norms = torch.stack(torch._foreach_norm(grads))
    if sharded is not None and any(sharded):
        from eyegaze_tpu_torch.parallel import tensor

        mask = torch.tensor(sharded, device=norms.device)
        squares = norms.square()
        norm = (tensor.sharded_sum(squares[mask].sum()) + squares[~mask].sum()).sqrt()
    else:
        norm = torch.linalg.vector_norm(norms)
    if max_norm is not None:
        clip = norm >= max_norm
        torch._foreach_div_(grads, torch.where(clip, norm, 1.0))
        torch._foreach_mul_(grads, torch.where(clip, max_norm, 1.0))
    return norm


class Optimizer:
    """Clip, then AdamW with each group's LR at the current update count.

    ``step()`` reads every parameter's ``.grad`` (a parameter the loss did
    not reach counts as a zero gradient, so it still decays, as in optax),
    updates the parameters in place and returns the global gradient norm
    before clipping.  ``count`` is the number of updates taken.
    """

    def __init__(self, named_parameters: Iterable[Tuple[str, torch.nn.Parameter]],
                 learning_rate: LearningRate, weight_decay: float = 0.01,
                 grad_clip: Optional[float] = 1.0,
                 param_groups: Optional[Callable[[str, torch.Tensor], str]] = None,
                 group_lrs: Optional[Dict[str, LearningRate]] = None,
                 frozen_groups: Sequence[str] = ()):
        named = list(named_parameters)
        self.params = [p for _, p in named]
        self.grad_clip = grad_clip
        groups: Dict[str, list] = {}
        for name, p in named:
            groups.setdefault(param_groups(name, p) if param_groups else "default", []).append(p)
        group_lrs = group_lrs or {}
        self.lrs = []
        torch_groups = []
        for g, params in groups.items():
            if g in frozen_groups:
                continue
            self.lrs.append(group_lrs.get(g, learning_rate))
            torch_groups.append({"params": params, "lr": self._lr(self.lrs[-1], 0)})
        self.adamw = torch.optim.AdamW(torch_groups, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=weight_decay)
        self.count = 0

    @staticmethod
    def _lr(lr: LearningRate, step: int) -> float:
        return float(lr(step)) if callable(lr) else float(lr)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.grad_clip,
                                    [hasattr(p, "tp_shard") for p in self.params])
        for group, lr in zip(self.adamw.param_groups, self.lrs):
            group["lr"] = self._lr(lr, self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def make_optimizer(model: torch.nn.Module, learning_rate: LearningRate,
                   weight_decay: float = 0.01, grad_clip: Optional[float] = 1.0,
                   param_groups: Optional[Callable[[str, torch.Tensor], str]] = None,
                   group_lrs: Optional[Dict[str, LearningRate]] = None,
                   frozen_groups: Sequence[str] = ()) -> Optimizer:
    """The counterpart of the JAX ``make_optimizer`` over ``model``'s
    parameters (``param_groups`` sees their state_dict names)."""
    return Optimizer(model.named_parameters(), learning_rate, weight_decay, grad_clip,
                     param_groups, group_lrs, frozen_groups)
