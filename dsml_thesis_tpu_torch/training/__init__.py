"""Training stack of the port: EMA, LR schedules, the train / eval steps,
checkpoint bookkeeping, loggers and the config-driven ``Trainer``; the
first-stage steps (``vqgan``, ``kl_ae``) and their trainers
(``vqgan_trainer``)."""
from .ema import ema_decay, ema_update  # noqa: F401
from .lr_scheduler import build_lr_multiplier  # noqa: F401
from .train_state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
