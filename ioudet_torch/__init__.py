"""ioudet_torch: the PyTorch and CUDA port of ``ioudet`` for NVIDIA Hopper.

``ioudet`` (JAX/Flax/Pallas) is the reference this package is tested
against; the layout mirrors its tree and names.  This package imports torch
and never jax.  The serving slice is ported: device preprocess, ResNet-FPN,
the IoU-aware RetinaNet head's inference and a hand-written CUDA greedy NMS.
"""

__version__ = "0.1.0"
