"""Train state and the train / eval steps.

Counterpart of ``dsml_thesis_tpu/training/train_state.py``:
  - AdamW (``torch.optim.AdamW``: betas 0.9 / 0.999, eps 1e-8, decoupled
    weight decay 0.01) over the trainable groups only; the frozen first
    stage, non-trainable cond stages and declared frozen sub-paths never
    enter the optimizer, so weight decay cannot erode them;
  - LR = base LR x multiplier(n), n the optimizer-step count from 0;
  - gradient accumulation: the mean of k micro-batches is applied on every
    k-th micro-step; the step counter and the EMA move on every micro-step,
    as the JAX step's do under ``optax.MultiSteps``;
  - EMA shadows of the trainable parameters only, updated after each step;
  - validation evaluates the loss twice, with the raw and the EMA weights
    (``val_loss`` / ``val_loss_ema``), in the validation form of the loss.

``DSML_OPT_BF16_M=1`` keeps the first Adam moment in bf16 (``AdamWBf16M``,
optax's ``mu_dtype``); the second moment stays fp32. The flag is read where
the LDM trainer (and the finetune trainer built on it) makes its optimizer,
as in the JAX package; the first-stage trainers' Adam does not read it.

Differences from the JAX package, all deliberate: the state is mutated in
place (parameters, moments and shadows are updated where they lie, nothing is
donated or copied); random draws come from a ``torch.Generator`` reseeded
from (seed, step) each step, the counterpart of ``fold_in(rng, step)``, so a
resumed run continues the same stream.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Callable, Dict, List, Optional

import torch

from ..flags import env_flag
from .ema import ema_update
from .lr_scheduler import build_lr_multiplier


def fold_seed(seed: int, step: int) -> int:
    """A generator seed for (seed, step): distinct streams for distinct
    steps of one run and for equal steps of runs with different seeds."""
    return (int(seed) * 1_000_003 + int(step)) % (2 ** 63 - 1)


@dataclasses.dataclass
class TrainState:
    """Everything a step updates. ``names`` / ``params`` / ``ema_params`` are
    aligned lists over the trainable parameters (``names`` as the model's
    ``state_dict`` spells them); ``step`` counts micro-steps."""

    step: int
    names: List[str]
    params: List[torch.nn.Parameter]
    ema_params: List[torch.Tensor]
    optimizer: torch.optim.Optimizer
    base_lr: float
    lr_multiplier: Optional[Callable[[int], float]]
    grad_accum: int
    generator: torch.Generator

    @property
    def optimizer_steps(self) -> int:
        return self.step // self.grad_accum

    def lr_at(self, n: int) -> float:
        """Learning rate of optimizer step n (counted from 0)."""
        if self.lr_multiplier is None:
            return self.base_lr
        return self.base_lr * self.lr_multiplier(n)

    @contextlib.contextmanager
    def ema_scope(self):
        """The EMA weights swapped in for the trainable parameters inside the
        block (by reference: nothing is copied), the raw ones back after."""
        raw = [p.data for p in self.params]
        for p, e in zip(self.params, self.ema_params):
            p.data = e
        try:
            yield
        finally:
            for p, r in zip(self.params, raw):
                p.data = r

    def state_dict(self) -> Dict:
        return {"step": self.step,
                "optimizer": self.optimizer.state_dict(),
                "ema": dict(zip(self.names, self.ema_params))}

    def load_state_dict(self, sd: Dict) -> None:
        if set(sd["ema"]) != set(self.names):
            raise ValueError("checkpoint EMA shadows do not match the "
                             "trainable parameters of this model")
        self.step = int(sd["step"])
        self.optimizer.load_state_dict(sd["optimizer"])
        with torch.no_grad():
            for name, e in zip(self.names, self.ema_params):
                e.copy_(sd["ema"][name])


class AdamWBf16M(torch.optim.Optimizer):
    """AdamW with its first moment stored in bf16, step for step what the
    JAX package's jitted step computes with ``optax.adamw(...,
    mu_dtype="bfloat16")``: ``b1 * mu`` with the Python ``b1`` rounded to
    bf16 (0.8984375, as JAX casts a Python scalar to the array's type) and
    the product kept in fp32 (exact: XLA drops the bf16 rounding of the
    product inside its fused kernel), plus ``(1 - b1) * g`` in fp32; the
    bias-corrected update from that fp32 moment, which alone is rounded back
    to bf16 to be kept; the second moment, the bias corrections and the
    update in fp32; decoupled weight decay added to the update before the
    learning rate scales it. ``torch.optim.AdamW`` on a bf16 ``exp_avg``
    would form the moment by a bf16 ``lerp_``, a different result. The
    update runs as ``torch._foreach_*`` ops over chunks of at most
    ``CHUNK`` elements, so that its fp32 temporaries stay that size."""

    CHUNK = 1 << 25

    def __init__(self, params, lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.01):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    def _chunks(self, group):
        """The group's parameters with a gradient, their state made and
        stepped, in chunks of one step count and at most CHUNK elements."""
        chunks, cur, size, step = [], [], 0, None
        for p in group["params"]:
            if p.grad is None:
                continue
            st = self.state[p]
            if not st:
                st["step"] = 0
                st["exp_avg"] = torch.zeros_like(
                    p, dtype=torch.bfloat16,
                    memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            st["step"] += 1
            if cur and (size + p.numel() > self.CHUNK or st["step"] != step):
                chunks.append((step, cur))
                cur, size = [], 0
            cur.append(p)
            size += p.numel()
            step = st["step"]
        if cur:
            chunks.append((step, cur))
        return chunks

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamWBf16M takes no closure")
        f32 = torch.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            for t, ps in self._chunks(group):
                # the bias corrections in fp32, as optax forms them
                bc1 = float(1 - torch.tensor(b1, dtype=f32) ** t)
                bc2 = float(1 - torch.tensor(b2, dtype=f32) ** t)
                g = [p.grad for p in ps]
                mu = [self.state[p]["exp_avg"] for p in ps]
                nu = [self.state[p]["exp_avg_sq"] for p in ps]
                m = torch._foreach_mul(g, 1 - b1)
                # + b1 * mu: the product of two 8-bit significands is exact
                # in fp32, so a fused multiply-add rounds as two ops do
                torch._foreach_add_(m, mu, alpha=b1_bf16)
                gg = torch._foreach_mul(g, g)
                torch._foreach_mul_(gg, 1 - b2)
                torch._foreach_mul_(nu, b2)
                torch._foreach_add_(nu, gg)
                torch._foreach_copy_(mu, m)
                d = torch._foreach_div(nu, bc2)
                torch._foreach_sqrt_(d)
                torch._foreach_add_(d, eps)
                torch._foreach_div_(m, bc1)
                torch._foreach_div_(m, d)
                torch._foreach_add_(m, torch._foreach_mul(ps, wd))
                torch._foreach_mul_(m, -lr)
                torch._foreach_add_(ps, m)
        return None

    def load_state_dict(self, state_dict) -> None:
        """As the base class's, which casts every floating state tensor to
        its parameter's type; the first moment goes back to bf16 (exact:
        its fp32 copy holds bf16 values)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


def make_optimizer(ldm, base_lr: float, weight_decay: float = 0.01
                   ) -> torch.optim.Optimizer:
    """AdamW over ``ldm.named_trainable_parameters()`` (and sets
    ``requires_grad`` to match); ``AdamWBf16M`` under
    ``DSML_OPT_BF16_M=1``. The step sets the LR before each update."""
    ldm.configure_trainable()
    params = [p for _, _, p in ldm.named_trainable_parameters()]
    if env_flag("DSML_OPT_BF16_M", False):
        return AdamWBf16M(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                          weight_decay=weight_decay)
    return torch.optim.AdamW(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(ldm, optimizer: torch.optim.Optimizer, base_lr: float,
                       scheduler_config: Optional[dict] = None,
                       grad_accum: int = 1) -> TrainState:
    named = list(ldm.named_trainable_parameters())
    params = [p for _, _, p in named]
    return TrainState(
        step=0,
        names=[f"{g.replace('/', '.')}.{n}" for g, n, _ in named],
        params=params,
        ema_params=[p.detach().clone() for p in params],
        optimizer=optimizer,
        base_lr=base_lr,
        lr_multiplier=(build_lr_multiplier(scheduler_config)
                       if scheduler_config is not None else None),
        grad_accum=max(1, int(grad_accum)),
        generator=torch.Generator(device=params[0].device),
    )


def _loss_kwargs(loss_module) -> set:
    return set(inspect.signature(loss_module.training_loss).parameters)


def make_train_step(loss_module, ema_decay: float = 0.9999) -> Callable:
    """``loss_module``: anything with ``training_loss(batch, generator) ->
    (loss, aux dict)`` whose parameters are those of the state: the
    LatentDiffusion itself or a wrapper over it. A loss declaring a
    ``global_step`` argument receives the live step counter."""
    takes_step = "global_step" in _loss_kwargs(loss_module)

    def train_step(state: TrainState, batch: Dict, seed: int) -> Dict:
        state.generator.manual_seed(fold_seed(seed, state.step))
        kw = {"global_step": state.step} if takes_step else {}
        loss, aux = loss_module.training_loss(batch, state.generator, **kw)
        # .grad holds the running sum of micro-batch gradients / k: their mean
        (loss / state.grad_accum).backward()
        state.step += 1
        if state.step % state.grad_accum == 0:
            lr = state.lr_at(state.optimizer_steps - 1)
            for group in state.optimizer.param_groups:
                group["lr"] = lr
            # a parameter the loss did not reach has no gradient, and AdamW
            # would skip it; the JAX step sees a zero gradient there and
            # still applies the weight decay: give it the zero
            for p in state.params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
        ema_update(state.ema_params, state.params, state.step, decay=ema_decay)
        return {f"train/{k}": v.detach() for k, v in aux.items()}

    return train_step


def make_eval_step(loss_module) -> Callable:
    """Validation form of the loss (random t / noise stay, the label drop and
    training-mode routing turn off), once with the raw and once with the EMA
    weights on the same draws."""
    args = _loss_kwargs(loss_module)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict, seed: int) -> Dict:
        kw = {"global_step": state.step} if "global_step" in args else {}
        if "training" in args:
            kw["training"] = False
        state.generator.manual_seed(seed)
        _, aux = loss_module.training_loss(batch, state.generator, **kw)
        state.generator.manual_seed(seed)
        with state.ema_scope():
            _, aux_ema = loss_module.training_loss(batch, state.generator, **kw)
        out = {f"val/{k}": v for k, v in aux.items()}
        out["val_loss"] = aux.get("loss_simple", aux["loss"])
        out["val_loss_ema"] = aux_ema.get("loss_simple", aux_ema["loss"])
        return out

    return eval_step
