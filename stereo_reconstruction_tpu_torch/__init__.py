"""stereo_reconstruction_tpu_torch — the PyTorch + CUDA port of
``stereo_reconstruction_tpu``.

The JAX package stays the reference; this package mirrors its module
paths so each counterpart is easy to find. Plain tensor code is PyTorch
on an explicit ``device``; each Pallas kernel of the JAX package, its
exact row scan and the perceptual matcher's smoother are CUDA C++ kernels
for Hopper in ``csrc/`` (wrappers in ``ops/cuda_*.py`` and
``perceptual/scan.py``). The entry points are ``pipeline.run_pair``,
``pipeline_batch.run_batch`` and ``python -m stereo_reconstruction_tpu_torch``
(``cli.py``).

This package imports ``torch`` and never ``jax`` (nor the JAX package,
whose ``__init__`` imports JAX).
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of the JAX package pinning matmul precision to "highest":
# float32 matmuls and cuDNN convolutions really run in float32, never TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from stereo_reconstruction_tpu_torch.config import PipelineConfig  # noqa: E402,F401
