"""ioudet_torch: the PyTorch and CUDA port of ``ioudet`` for NVIDIA Hopper.

``ioudet`` (JAX/Flax/Pallas) is the reference this package is tested
against; the layout mirrors its tree and names.  This package imports torch
and never jax.  Ported: serving (device preprocess, ResNet / ResNeXt with
deformable convs and global-context blocks, FPN, the IoU-aware RetinaNet
head, a hand-written CUDA greedy NMS, multi-scale flip test-time
augmentation), training (anchor assignment and focal loss in hand-written
CUDA; SGD, Adam and AdamW; f32 or bf16 compute; data parallel over a
``torch.distributed`` group, one process a card; resuming from ``ioudet``'s
checkpoint directories), low-precision serving, and evaluation (COCO- and
VOC-style datasets, their pipeline and loader, ``single_device_test``,
``multi_host_test``, ``tta_test``, COCOeval, VOC mAP).
"""

__version__ = "0.1.0"
