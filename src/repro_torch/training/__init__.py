from .steps import (
    TrainerConfig,
    batch_to_torch,
    make_loss_fn,
    make_train_step,
    value_and_grad,
)

__all__ = ["TrainerConfig", "batch_to_torch", "make_loss_fn",
           "make_train_step", "value_and_grad"]
