"""CFEAR-class radar odometry / SLAM engine in JAX.

A brand-new JAX/XLA/Pallas implementation of the capabilities of
``dan11003/CFEAR_Radarodometry_code_public`` (spinning FMCW radar ego-motion
estimation), re-architected around fixed-shape array programs:

- polar-image k-strongest / CA-CFAR filtering as fixed-shape masked top-k
  (reference: src/cfear_radarodometry/radar_filters.cpp, cfar.cpp)
- oriented-surface-point extraction as dense grid scatter-add moments with an
  analytic 2x2 eigendecomposition (reference: src/cfear_radarodometry/pointnormal.cpp)
- scan-to-multi-keyframe registration as a batched IRLS Gauss-Newton /
  Levenberg-Marquardt solver with exact brute-force 1-NN association
  (reference: src/cfear_radarodometry/n_scan_normal.cpp)
- keyframe odometry orchestration as a pure scan-carry pipeline under
  jax.lax.scan (reference: src/cfear_radarodometry/odometrykeyframefuser.cpp)
- pose-graph back-end with collective-parallel Gauss-Newton
  (reference: include/cfear_radarodometry/types.h simple_graph)

See SURVEY.md at the repository root for the full component map.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry at 100+ m extents cannot survive reduced-precision matmuls: on
# the GPU, "highest" keeps f32 products out of TF32 (about three decimal
# digits), which would put decimeter-level error into distance computations
# and pose transforms. The hot matmuls here are tiny, so the cost is
# negligible.
_jax.config.update("jax_default_matmul_precision", "highest")

from cfear_jax.config import (  # noqa: F401
    CFEARConfig,
    FeatureConfig,
    FilterConfig,
    OdometryConfig,
    RadarConfig,
    RegistrationConfig,
    preset,
)
