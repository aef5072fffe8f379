"""Timestep-keyed state banks for the autoregressive window loop.

Counterpart of ``actionmesh_tpu/utils/banks.py``. Timestep keys are host
floats; latents stay device tensors. A missing timestep yields a zero
latent and mask 0, which drives Stage I's inpainting-style conditioning.
"""

from __future__ import annotations

import logging
from typing import Generic, Optional, Sequence, TypeVar

import numpy as np
import torch

logger = logging.getLogger(__name__)

T = TypeVar("T")

_EPS = 1e-5


class TimestepIndexedStorage(Generic[T]):
    """Items keyed by float timestep, matched within an epsilon."""

    def __init__(self, verbose: bool = False):
        self.items: list[T] = []
        self.timesteps: list[float] = []
        self.verbose = verbose

    @property
    def n_timesteps(self) -> int:
        return len(self.timesteps)

    def get_timestep_index(self, timestep: float, eps: float = _EPS) -> Optional[int]:
        for index, ts in enumerate(self.timesteps):
            if abs(ts - timestep) < eps:
                return index
        return None

    def _update_many(self, timesteps: np.ndarray, items: Sequence) -> None:
        """Add items at new timesteps; a timestep already held keeps its item."""
        added = []
        for t, item in zip(timesteps, items):
            t = float(t)
            if self.get_timestep_index(t) is None:
                self.timesteps.append(t)
                self.items.append(item)
                added.append(t)
        if self.verbose and added:
            logger.info("[%s] Added timesteps %s", self.__class__.__name__.upper(), added)

    def _get_ordered_indices(self) -> list[int]:
        return sorted(range(len(self.timesteps)), key=lambda i: self.timesteps[i])

    def get_ordered_timesteps(self) -> np.ndarray:
        return np.array(
            [self.timesteps[i] for i in self._get_ordered_indices()], dtype=np.float32
        )


class LatentBank(TimestepIndexedStorage[torch.Tensor]):
    """Device-resident latent storage keyed by timestep."""

    def __init__(
        self,
        empty_dims: tuple[int, ...] = (768, 64),
        device: Optional[torch.device] = None,
        verbose: bool = False,
    ):
        super().__init__(verbose=verbose)
        self.empty_dims = tuple(empty_dims)
        self.device = device

    def update(self, timesteps: np.ndarray, latents: torch.Tensor) -> None:
        """Store latents (any leading shape reshaping to (n, *empty_dims))."""
        ts = np.asarray(timesteps).reshape(-1)
        latents = latents.reshape((ts.shape[0],) + self.empty_dims)
        self._update_many(ts, list(latents))

    def get(
        self, timesteps: np.ndarray, add_batch_dim: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(latents (n, *dims), mask (n,) int32: 1 where the bank holds one)."""
        latents, masks = [], []
        for t in np.asarray(timesteps).reshape(-1):
            index = self.get_timestep_index(float(t))
            if index is None:
                latents.append(
                    torch.zeros(self.empty_dims, dtype=torch.float32, device=self.device)
                )
                masks.append(0)
            else:
                latents.append(self.items[index])
                masks.append(1)
        latents_out = torch.stack(latents)
        masks_out = torch.tensor(masks, dtype=torch.int32, device=latents_out.device)
        if add_batch_dim:
            return latents_out[None], masks_out[None]
        return latents_out, masks_out


class MeshBank(TimestepIndexedStorage):
    """Host-side mesh storage keyed by timestep."""

    def update(self, timesteps: np.ndarray, meshes: Sequence) -> None:
        ts = np.asarray(timesteps).reshape(-1)
        if ts.shape[0] != len(meshes):
            raise ValueError(f"{ts.shape[0]} timesteps for {len(meshes)} meshes")
        self._update_many(ts, meshes)

    def get(self, timesteps: np.ndarray) -> list:
        out = []
        for t in np.asarray(timesteps).reshape(-1):
            index = self.get_timestep_index(float(t))
            out.append(self.items[index] if index is not None else None)
        return out

    def get_ordered(self) -> tuple[list, np.ndarray]:
        order = self._get_ordered_indices()
        return (
            [self.items[i] for i in order],
            np.array([self.timesteps[i] for i in order], dtype=np.float32),
        )
