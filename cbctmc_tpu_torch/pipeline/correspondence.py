"""Respiratory correspondence model: signal -> dense displacement field.

Wilms et al. 2014 (doi:10.1088/0031-9155/59/5/1147) multivariate linear
regression between a low-dimensional breathing surrogate (amplitude +
derivative) and per-voxel displacement fields, fitted over the phases of a
4D CT. Re-design of the reference (cbctmc/registration/correspondence.py):
fit/predict are plain linear algebra in numpy float64 on the host; the
displacement fields for *building* the model come from deformable
registration (:mod:`cbctmc_tpu_torch.registration.demons`, on the card) or
external inputs. The port's copy of the JAX package's
``pipeline/correspondence.py``: a model the JAX package saved (a pickle of a
dict of numpy arrays) loads here.
"""

from __future__ import annotations

import logging
import pickle
from hashlib import sha256
from pathlib import Path
from typing import Sequence

import numpy as np

from cbctmc_tpu_torch.geometry.mc_geometry import _ArrayUnpickler

logger = logging.getLogger(__name__)


def regularize_matrix(
    matrix: np.ndarray,
    condition_number_threshold: float = 30.0,
    step_size: float = 1e-3,
    max_regularization: float = 1.0,
) -> np.ndarray:
    """Iterative Tikhonov regularisation: grow a diagonal loading until the
    condition number drops below the threshold
    (reference: correspondence.py:97-147)."""
    if (
        np.linalg.matrix_rank(matrix) == min(matrix.shape)
        and np.linalg.cond(matrix) <= condition_number_threshold
    ):
        return matrix

    loading = 0.0
    while True:
        loading += step_size
        if loading > max_regularization:
            raise RuntimeError(
                "Matrix regularization failed: Tikhonov loading exceeded "
                f"{max_regularization}"
            )
        regularized = matrix + np.eye(matrix.shape[0]) * loading
        if np.linalg.cond(regularized) <= condition_number_threshold:
            logger.info("Tikhonov-regularized matrix with loading %g", loading)
            return regularized


class CorrespondenceModel:
    """signal (d,) -> displacement field (3, x, y, z) in voxel units."""

    def __init__(self):
        self.coefficients: np.ndarray | None = None  # (3*x*y*z, d)
        self.timesteps: int | None = None
        self.mean_signal: np.ndarray | None = None  # (d, 1)
        self.signal_n_dims: int | None = None
        self.mean_vector_field: np.ndarray | None = None  # (3*x*y*z, 1)
        self.spatial_shape = None
        self.signals: np.ndarray | None = None
        self.reference_phase: int | None = None

    @property
    def is_fitted(self) -> bool:
        return all(
            v is not None
            for v in (self.coefficients, self.mean_signal, self.mean_vector_field)
        )

    @property
    def model_hash(self) -> str:
        if not self.is_fitted:
            raise RuntimeError("Correspondence model is not fitted")
        hasher = sha256()
        hasher.update(self.coefficients.tobytes())
        hasher.update(int(self.timesteps).to_bytes(8, "little"))
        hasher.update(self.mean_signal.tobytes())
        hasher.update(self.mean_vector_field.tobytes())
        hasher.update(self.signals.tobytes())
        hasher.update(int(self.reference_phase).to_bytes(8, "little"))
        return hasher.hexdigest()

    # ------------------------------------------------------------------
    def fit(
        self,
        vector_fields: np.ndarray,  # (timesteps, 3, x, y, z)
        signals: np.ndarray,  # (signal_n_dims, timesteps) or (timesteps, d)
        reference_phase: int = 2,
    ) -> "CorrespondenceModel":
        """Ordinary least squares of centred displacement fields against
        centred signals, with Tikhonov-stabilised normal equations."""
        self.spatial_shape = vector_fields.shape[2:]
        self.timesteps = vector_fields.shape[0]
        fields = vector_fields.reshape(self.timesteps, -1).T  # (3xyz, t)
        self.mean_vector_field = fields.mean(axis=1, keepdims=True)

        # contract: signals is (signal_n_dims, timesteps) — the natural
        # np.stack([signal, dt_signal]) layout. (The reference reshapes a
        # (d, t) input as (t, d), silently interleaving the surrogate
        # components; we fix the convention instead of inheriting that.)
        signals = np.asarray(signals, np.float64).reshape(-1, self.timesteps)
        self.signal_n_dims = signals.shape[0]
        self.mean_signal = signals.mean(axis=1, keepdims=True)

        centered_fields = fields - self.mean_vector_field
        centered_signals = signals - self.mean_signal

        if self.timesteps >= self.signal_n_dims:
            cov = centered_signals @ centered_signals.T
            pinv = centered_signals.T @ np.linalg.inv(regularize_matrix(cov))
        else:
            cov = centered_signals.T @ centered_signals
            pinv = np.linalg.inv(regularize_matrix(cov)) @ centered_signals.T

        self.coefficients = (centered_fields @ pinv).astype(np.float32)
        self.mean_vector_field = self.mean_vector_field.astype(np.float32)
        self.signals = signals
        self.reference_phase = reference_phase
        return self

    def predict(self, signal: np.ndarray) -> np.ndarray:
        if not self.is_fitted:
            raise RuntimeError("Correspondence model is not fitted")
        signal = np.asarray(signal, np.float64).reshape(-1)
        if signal.shape != (self.signal_n_dims,):
            raise ValueError(
                f"Expected signal of shape ({self.signal_n_dims},), "
                f"got {signal.shape}"
            )
        centered = signal[:, None] - self.mean_signal
        prediction = self.mean_vector_field + self.coefficients @ centered
        return prediction.reshape(3, *self.spatial_shape)

    # ------------------------------------------------------------------
    def save(self, filepath, include_model_hash: bool = True) -> Path:
        filepath = Path(filepath).with_suffix(".pkl")
        if include_model_hash:
            filepath = filepath.with_name(
                f"{filepath.stem}_{self.model_hash[:7]}{filepath.suffix}"
            )
        with open(filepath, "wb") as f:
            pickle.dump(
                {
                    "coefficients": self.coefficients,
                    "timesteps": self.timesteps,
                    "mean_signal": self.mean_signal,
                    "signal_n_dims": self.signal_n_dims,
                    "mean_vector_field": self.mean_vector_field,
                    "spatial_shape": self.spatial_shape,
                    "signals": self.signals,
                    "reference_phase": self.reference_phase,
                },
                f,
            )
        return filepath

    @classmethod
    def load(cls, filepath) -> "CorrespondenceModel":
        with open(filepath, "rb") as f:
            data = _ArrayUnpickler(f).load()
        if not isinstance(data, dict):
            raise TypeError(f"{filepath}: not a correspondence-model dict payload")
        model = cls()
        for key, value in data.items():
            setattr(model, key, value)
        return model

    # ------------------------------------------------------------------
    @classmethod
    def build_default(
        cls,
        images: np.ndarray,  # (phases, x, y, z)
        signals: np.ndarray | None = None,
        masks: np.ndarray | None = None,
        timepoints: Sequence[float] | None = None,
        reference_phase: int = 2,
        registration_kwargs: dict | None = None,
        device=None,
    ) -> "CorrespondenceModel":
        """Fit from a 4D CT: register every phase to the reference phase with
        the built-in diffeomorphic demons registration (on ``device``,
        ``cuda`` unless the caller passes ``"cpu"``), derive the surrogate
        from lung-mask volumes when no signal is given
        (reference: correspondence.py:277-356)."""
        from cbctmc_tpu_torch.registration.demons import register_phases

        if signals is None:
            if masks is None or timepoints is None:
                raise ValueError("Either signals or (masks and timepoints) required")
            from cbctmc_tpu_torch.pipeline.respiratory import RespiratorySignal

            resp = RespiratorySignal.from_masks(masks=masks, timepoints=timepoints)
            signal = np.interp(timepoints, resp.time, resp.signal)
            dt_signal = np.interp(timepoints, resp.time, resp.dt_signal)
            signals = np.stack([signal, dt_signal], axis=0)

        vector_fields = register_phases(
            images, reference_index=reference_phase, masks=masks, device=device,
            **(registration_kwargs or {})
        )
        return cls().fit(
            vector_fields=vector_fields,
            signals=signals,
            reference_phase=reference_phase,
        )
