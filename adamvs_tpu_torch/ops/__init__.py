"""The port's plain operations, exported under the JAX package's names
(adamvs_tpu/ops/__init__.py); the kernels' wrappers live in their modules."""

from .regression import (
    depth_regression,
    online_softmax_finalize,
    online_softmax_init,
    online_softmax_update,
)
from .sampling import uniform_depth_samples, window_min_and_interval, windowed_depth_samples
from .warp import bilinear_sample, plane_sweep_warp, warp_transform
