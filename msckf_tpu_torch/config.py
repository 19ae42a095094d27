"""Filter configuration: the PyTorch port's copy of ``msckf_tpu/config.py``.

``MSCKFConfig`` mirrors the JAX package's dataclass field for field, with the
same defaults, so a configuration means the same filter in both packages.
The only difference is :attr:`MSCKFConfig.jdtype`, which is a ``torch.dtype``
here. The config is frozen and hashable, which lets per-device constant
tensors be cached by config (``filter/state.py::device_consts``). The port
runs every setting of the JAX package's filter.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Tuple

import numpy as np
import torch


def _t3x3(m) -> Tuple[Tuple[float, ...], ...]:
    a = np.asarray(m, dtype=np.float64)
    return tuple(tuple(float(x) for x in row) for row in a)


def _t3(v) -> Tuple[float, ...]:
    return tuple(float(x) for x in np.asarray(v, dtype=np.float64))


# Reference default camera extrinsics: camera z forward, x right, y down,
# expressed in the world/IMU frame.
_DEFAULT_R_WC = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))
_DEFAULT_K = ((180.0, 0.0, 320.0), (0.0, 180.0, 240.0), (0.0, 0.0, 1.0))

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class MSCKFConfig:
    # --- camera ---
    R_WC: Tuple[Tuple[float, ...], ...] = _DEFAULT_R_WC
    t_WC: Tuple[float, ...] = (0.0, 0.0, 0.0)
    K: Tuple[Tuple[float, ...], ...] = _DEFAULT_K
    width: int = 640
    height: int = 480
    sigma_image: float = 0.2

    # --- IMU ---
    only_imu: bool = False
    accelerometer_noise_density: float = 0.001
    accelerometer_random_walk: float = 0.00001
    gyroscope_noise_density: float = 0.0001
    gyroscope_random_walk: float = 0.000001
    gravity: Tuple[float, ...] = (0.0, 0.0, -9.81)
    # 0 keeps the reference's literal density convention; the IMU sample
    # rate declares the configured numbers per-sample sigmas instead
    noise_input_rate: float = 0.0

    # --- features ---
    number_of_extracted_features: int = 256
    min_cosine_similarity: float = 0.82
    use_parallax: bool = True
    min_parallax_deg: float = 20.0
    epipolar_rejection_threshold: float = 5.0
    homography_rejection_threshold: float = 5.0
    min_frames_to_be_lost: int = 1  # clamped >= 1
    min_frames_to_be_tracked: int = 5  # clamped >= 2
    max_camera_states: int = 30

    # --- fixed buffer capacities (shape-defining) ---
    n_cam_slots: int = 32
    m_max: int = 32
    f_max: int = 768
    k_max: int = 512
    desc_dim: int = 64
    u_max: int = 128

    # --- triangulation ablation ---
    triangulation: str = "lines"
    gn_iters: int = 5
    # kernel switches (names kept from the JAX package)
    use_pallas: bool = True
    use_pallas_triage: bool = True
    use_pallas_propagation: bool = True
    batched_solver: str = "ns"
    solver_ns_iters: int = 12
    gain_solver: str = "lu"
    update_kernel: str = "hybrid"
    gating_solver: str = "auto"
    gating_ns_iters: int = 16
    prune_path: str = "cond"

    # --- numerics ---
    dtype: str = "float32"
    # "float64": the EKF correction chain runs in float64 (a real f64
    # island on the GPU); "compensated": in double-word float32 for a
    # float32 filter (ops/compensated.py), whose refinement solves by the
    # LU for either island_solver (the JAX package's "ns" is a
    # Newton-Schulz inverse); any other value: plain ``dtype``
    correction_dtype: str = "float64"
    island_solver: str = "lu"

    def __post_init__(self):
        object.__setattr__(self, "R_WC", _t3x3(self.R_WC))
        object.__setattr__(self, "t_WC", _t3(self.t_WC))
        object.__setattr__(self, "K", _t3x3(self.K))
        object.__setattr__(self, "gravity", _t3(self.gravity))
        object.__setattr__(
            self, "min_frames_to_be_lost", max(self.min_frames_to_be_lost, 1)
        )
        object.__setattr__(
            self, "min_frames_to_be_tracked", max(self.min_frames_to_be_tracked, 2)
        )
        if self.n_cam_slots <= self.max_camera_states:
            raise ValueError("n_cam_slots must exceed max_camera_states")
        if self.m_max > self.n_cam_slots:
            raise ValueError("m_max must not exceed n_cam_slots")

    # --- derived ---

    @property
    def jdtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def err_dim(self) -> int:
        """Padded error-state dimension: 15 IMU + 6 per camera slot."""
        return 15 + 6 * self.n_cam_slots

    @cached_property
    def K_np(self) -> np.ndarray:
        return np.asarray(self.K, dtype=np.float64)

    @cached_property
    def K_inv_np(self) -> np.ndarray:
        return np.linalg.inv(self.K_np)

    @cached_property
    def R_WC_np(self) -> np.ndarray:
        return np.asarray(self.R_WC, dtype=np.float64)

    @cached_property
    def t_WC_np(self) -> np.ndarray:
        return np.asarray(self.t_WC, dtype=np.float64)

    @cached_property
    def gravity_np(self) -> np.ndarray:
        return np.asarray(self.gravity, dtype=np.float64)

    @cached_property
    def noise_cov_diag_np(self) -> np.ndarray:
        """Diagonal of the 12x12 continuous noise covariance:
        [sigma_g^2 I, sigma_bg^2 I, sigma_a^2 I, sigma_ba^2 I]."""
        d = np.array(
            [
                self.gyroscope_noise_density**2,
                self.gyroscope_random_walk**2,
                self.accelerometer_noise_density**2,
                self.accelerometer_random_walk**2,
            ]
        )
        if self.noise_input_rate > 0:
            f = self.noise_input_rate
            d = d * np.array([1.0 / f, f, 1.0 / f, f])
        return np.repeat(d, 3)

    @cached_property
    def chi2_table_np(self) -> np.ndarray:
        """chi2.ppf(0.95, dof) for dof = 0..2*m_max. The dof=0 entry is NaN,
        so the gate ``gamma <= crit`` fails there."""
        from scipy.stats import chi2

        dof = np.arange(0, 2 * self.m_max + 1)
        with np.errstate(invalid="ignore"):
            t = chi2.ppf(0.95, dof)
        return t


def reference_experiment_config(**overrides) -> MSCKFConfig:
    """The reference's experiment configuration (its ``main.py`` settings)."""
    base = dict(
        sigma_image=0.1,
        number_of_extracted_features=300,
        min_cosine_similarity=0.95,
        use_parallax=True,
        min_parallax_deg=45.0,
        epipolar_rejection_threshold=0.005,
        homography_rejection_threshold=5.0,
        min_frames_to_be_tracked=4,
        min_frames_to_be_lost=2,
        max_camera_states=30,
    )
    base.update(overrides)
    return MSCKFConfig(**base)


NOISE_PRESETS = {
    # (accel_nd, gyro_nd, accel_rw, gyro_rw)
    "high": (0.01, 0.001, 0.001, 0.0001),
    "mid": (0.005, 0.0005, 0.0005, 0.00005),
    "low": (0.001, 0.0001, 0.0001, 0.00001),
}
