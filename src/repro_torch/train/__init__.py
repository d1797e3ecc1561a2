"""Training substrate (port of ``repro.train``): AdamW and the train step."""
from .optimizer import OptConfig, adamw_update, global_norm, init_opt_state, lr_at
from .train_step import build_train_step, build_value_and_grad, init_train_state

__all__ = [k for k in dir() if not k.startswith("_")]
