from .accuracy import accuracy
from .cross_entropy_loss import (CrossEntropyLoss, binary_cross_entropy,
                                 binary_cross_entropy_with_logits, cross_entropy)
from .focal_loss import (FocalLoss, fused_level_focal_sum, sigmoid_focal_loss,
                         sigmoid_focal_loss_with_logits)
from .iou_loss import (BoundedIoULoss, GIoULoss, IoULoss, bounded_iou_loss, giou_loss,
                       iou_loss)
from .smooth_l1_loss import L1Loss, SmoothL1Loss, l1_loss, smooth_l1_loss
from .utils import reduce_loss, weight_reduce_loss, weighted_loss

__all__ = ["accuracy", "CrossEntropyLoss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "cross_entropy", "FocalLoss",
           "fused_level_focal_sum", "sigmoid_focal_loss",
           "sigmoid_focal_loss_with_logits", "BoundedIoULoss", "GIoULoss", "IoULoss",
           "bounded_iou_loss", "giou_loss", "iou_loss", "L1Loss", "SmoothL1Loss", "l1_loss",
           "smooth_l1_loss", "reduce_loss", "weight_reduce_loss", "weighted_loss"]
