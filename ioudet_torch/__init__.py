"""ioudet_torch: the PyTorch and CUDA port of ``ioudet`` for NVIDIA Hopper.

``ioudet`` (JAX/Flax/Pallas) is the reference this package is tested
against; the layout mirrors its tree and names.  This package imports torch
and never jax.  Ported: serving (device preprocess, ResNet / ResNeXt with
deformable convs and global-context blocks, FPN, the IoU-aware RetinaNet
head, a hand-written CUDA greedy NMS, multi-scale flip test-time
augmentation), training (anchor assignment and focal loss in hand-written
CUDA), low-precision serving, and evaluation (COCO- and VOC-style datasets,
their pipeline and loader, ``single_device_test``, ``tta_test``, COCOeval,
VOC mAP).
"""

__version__ = "0.1.0"
