"""Schedules, the Gaussian-diffusion training math, the samplers (DDIM,
DPM-Solver(++), PLMS, ancestral DDPM), split-input tiling and the video
pipeline of the port."""
from .ddim import (  # noqa: F401
    cfg_eps_fn,
    ddim_invert,
    ddim_reverse_from,
    ddim_sample,
    ddim_sample_with_intermediates,
    latent_manipulation,
    p_sample_ddim,
    stochastic_encode,
)
from .dpm_solver import (  # noqa: F401
    DPMSolverSchedule,
    VPContinuous,
    dpm_solver_sample,
    dpm_solver_sample_adaptive,
    dpm_solver_sample_suite,
    make_dpm_schedule,
    make_vp_continuous,
)
from .gaussian import (  # noqa: F401
    ddpm_p_sample_loop,
    get_loss,
    p_losses,
    predict_start_from_noise,
    q_posterior,
    q_sample,
)
from .plms import plms_sample  # noqa: F401
from .schedules import (  # noqa: F401
    DDIMSchedule,
    DiffusionSchedule,
    extract,
    make_beta_schedule,
    make_ddim_sampling_parameters,
    make_ddim_schedule,
    make_ddim_timesteps,
    make_schedule,
    make_strength_ddim_timesteps,
)
from .video import (  # noqa: F401
    audio_windows,
    make_video_pipeline,
    progressive_video_sample,
)
