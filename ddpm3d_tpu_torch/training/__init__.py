"""Training: timestep samplers, the train step and the host loop, and
progressive distillation."""

from .distill import (
    distill_losses,
    distill_phase,
    distill_schedules,
    distill_step,
    distill_targets,
    halve_timesteps,
    progressive_distill,
    target_to_model_space,
)
from .resample import (
    LossSecondMomentState,
    create_named_schedule_sampler,
    init_loss_second_moment,
    sample_loss_second_moment,
    sample_uniform,
    update_loss_second_moment,
)
from .train_loop import TrainLoop, TrainState, log_loss_dict, make_optimizer
