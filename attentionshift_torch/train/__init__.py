"""Training: the layer-decay AdamW recipe, the train state, the train and eval steps."""

from .optim import (Optimizer, build_optimizer, lr_scales, step_lr_schedule, vit_layer_id,
                    weight_decay_mask)
from .state import TrainState
from .step import make_eval_step, make_train_step

__all__ = ["Optimizer", "build_optimizer", "lr_scales", "step_lr_schedule", "vit_layer_id",
           "weight_decay_mask", "TrainState", "make_train_step", "make_eval_step"]
