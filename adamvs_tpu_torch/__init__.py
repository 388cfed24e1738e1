"""adamvs_tpu_torch: the PyTorch/CUDA port of adamvs_tpu for NVIDIA Hopper.

The tree mirrors ``adamvs_tpu`` (``ops/``, ``nn/``, ``models/``, ``predict/``,
``train/``, ``data/``, ``io/``, ``cli.py``) so each module's counterpart is easy
to find. Public functions keep
the JAX package's layouts (images [B,V,H,W,3], projections {"stageK":
[B,V,4,4]}, depth ranges [B,2], depth and confidence [B,H,W]); inside, the
model runs NCHW.

Every Pallas kernel of the JAX package has a hand-written CUDA C++
counterpart under ``csrc/``, built by ``kernels/build.py`` at first use, and
so has the gradient of the bilinear sampler (K6/K7), which the scan form's
training needs.
Each kernel wrapper takes its plain PyTorch version for tensors on the CPU and
launches the kernel (or raises) for tensors on a CUDA device.

This package imports torch, numpy and host libraries (PIL, OpenCV, optionally
tensorboardX), never jax or adamvs_tpu.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
