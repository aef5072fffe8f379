"""Shifted flow-matching sigma schedule (host numpy).

Copy of ``actionmesh_tpu/sampling/flow_schedule.py``.
"""

from __future__ import annotations

import numpy as np


def compute_timesteps(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    shift: float = 1.0,
) -> np.ndarray:
    """Shifted schedule sigma' = shift*sigma / (1 + (shift-1)*sigma).

    Returns (num_inference_steps,) float32 timesteps, descending.
    """
    full_sigmas = (
        np.linspace(1, num_train_timesteps, num_train_timesteps) / num_train_timesteps
    )[::-1]
    full_sigmas_shifted = shift * full_sigmas / (1 + (shift - 1) * full_sigmas)
    sigma_max = full_sigmas_shifted[0]
    sigma_min = full_sigmas_shifted[-1]
    timesteps = np.linspace(
        sigma_max * num_train_timesteps,
        sigma_min * num_train_timesteps,
        num_inference_steps,
    )
    sigmas = timesteps / num_train_timesteps
    sigmas = shift * sigmas / (1 + (shift - 1) * sigmas)
    return (sigmas * num_train_timesteps).astype(np.float32)


def get_schedule(
    num_inference_steps: int,
    num_train_timesteps: int = 1000,
    shift: float = 3.0,
) -> tuple[np.ndarray, np.ndarray]:
    """(timesteps (steps+1,), distances (steps,)) for the Euler loop."""
    timesteps = compute_timesteps(
        num_inference_steps=num_inference_steps + 1,
        num_train_timesteps=num_train_timesteps,
        shift=shift,
    )
    distances = (timesteps[:-1] - timesteps[1:]) / num_train_timesteps
    return timesteps, distances
