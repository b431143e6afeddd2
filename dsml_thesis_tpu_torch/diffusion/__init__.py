"""Schedules, the Gaussian-diffusion training math, the DDIM step and the
video pipeline of the port."""
from .ddim import cfg_eps_fn, p_sample_ddim  # noqa: F401
from .gaussian import (  # noqa: F401
    get_loss,
    p_losses,
    predict_start_from_noise,
    q_posterior,
    q_sample,
)
from .schedules import (  # noqa: F401
    DDIMSchedule,
    DiffusionSchedule,
    extract,
    make_beta_schedule,
    make_ddim_sampling_parameters,
    make_ddim_schedule,
    make_ddim_timesteps,
    make_schedule,
)
from .video import (  # noqa: F401
    audio_windows,
    make_video_pipeline,
    progressive_video_sample,
)
