"""PyTorch/CUDA port of ``objectdetectionpl_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one is the reference: every module here mirrors
a module of the same name there, and the tests hold each against its JAX
counterpart on the same inputs and weights.  This package imports torch,
numpy, yaml and the standard library only -- never jax, flax, optax or
anything under ``objectdetectionpl_tpu``.

Public layouts follow the JAX package: NHWC images in, YOLOv5 head maps
``[B, 3, g, g, 5+C]`` or YOLOv2/v3/v4 raw maps ``[B, A*(5+C), g, g]`` out,
``NMSResult`` fields ``[B, K, ...]``.  Entry points
run on CUDA unless the caller passes ``device="cpu"``
(:func:`objectdetectionpl_tpu_torch.device.resolve_device`).

The TPU's Pallas kernels become hand-written Hopper kernels under
``csrc/``, built with ``nvcc`` on first use (``ops/cuda/_build.py``).
"""

__version__ = "0.1.0"
