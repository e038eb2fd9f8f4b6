"""L1 physical models: motion, process, observation, scan sensor."""

from slamsim.models.motion import (MotionConfig, motion_mean, motion_sample,
                                   motion_sample_with_noise, noise_sigmas)
from slamsim.models.observation import (landmark_observation,
                                        position_observation)
from slamsim.models.process import circular_jacobian, circular_step
from slamsim.models.scan_sensor import (Scan, ScanConfig,
                                        cov_measurement_to_robot,
                                        cov_measurement_to_world,
                                        measurement_cov, scan,
                                        scan_apply_noise, scan_true)

__all__ = [
    "MotionConfig",
    "motion_mean",
    "motion_sample",
    "motion_sample_with_noise",
    "noise_sigmas",
    "landmark_observation",
    "position_observation",
    "circular_jacobian",
    "circular_step",
    "Scan",
    "ScanConfig",
    "cov_measurement_to_robot",
    "cov_measurement_to_world",
    "measurement_cov",
    "scan",
    "scan_apply_noise",
    "scan_true",
]
