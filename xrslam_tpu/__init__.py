"""xrslam_tpu — a JAX visual-inertial SLAM framework.

A from-scratch JAX/XLA re-design of the capabilities of
openxrlab/xrslam (RD-VIO): pyramidal-KLT feature tracking, IMU
preintegration, sliding-window visual-inertial bundle adjustment with
marginalization priors, subframe/keyframe management, IMU-PARSAC
dynamic-outlier rejection, and PnP visual localization.

Design stance (see SURVEY.md §7): fixed-shape array state (the sliding
window is a struct-of-arrays pytree), pure jitted step functions, and a
batched Gauss-Newton/LM core with explicit Schur complement over
landmarks — replacing the reference's pointer-graph + Ceres architecture
(reference: xrslam/src/xrslam/estimation/solver.cpp).
"""

__version__ = "0.1.0"

from . import geometry  # noqa: F401
