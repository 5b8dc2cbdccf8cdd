"""Training: timestep samplers, the train step and the host loop."""

from .resample import (
    LossSecondMomentState,
    init_loss_second_moment,
    sample_loss_second_moment,
    sample_uniform,
    update_loss_second_moment,
)
from .train_loop import TrainLoop, TrainState, log_loss_dict, make_optimizer
