"""Training on the GPU: the twin of ``repro.train``, cut to AdamW and the
step loop."""
from repro_torch.train.loop import Trainer, TrainerConfig, train_step
from repro_torch.train.optimizer import AdamWConfig, adamw_update, init_opt_state, schedule

__all__ = ["Trainer", "TrainerConfig", "train_step", "AdamWConfig", "adamw_update",
           "init_opt_state", "schedule"]
