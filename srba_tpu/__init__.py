"""srba_tpu — a Sparser Relative Bundle Adjustment framework in JAX.

Built from scratch with the capabilities of the C++ reference library
MRPT/srba (see SURVEY.md for the blueprint): incremental SLAM in relative
coordinates over a keyframe graph with bounded-depth spanning trees,
pluggable landmark/observation models, edge-creation policies with loop
closures, and local Levenberg-Marquardt with Schur-complement landmark
marginalization — batched device programs rather than a port.
"""

__version__ = "0.1.0"

from srba_tpu.engine.engine import (  # noqa: F401
    Observation,
    SrbaEngine,
    SrbaParams,
    TNewKeyFrameInfo,
)
from srba_tpu.ops.lie import SE2, SE3  # noqa: F401
