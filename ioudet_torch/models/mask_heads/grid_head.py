"""Grid head of Grid R-CNN (counterpart of
``ioudet/models/mask_heads/grid_head.py``): a 3x3 grid of points on each
box, predicted as 9 heatmaps over the roi, and the box read off the points.

Architecture, as ``ioudet`` builds it:
  * ``num_convs`` x (3x3 conv with bias, GN(36), ReLU) on the 14x14 RoI
    features, to ``grid_points * point_feat_channels`` channels (one group
    of ``point_feat_channels`` a point);
  * two fusion orders: each point's group plus a dense 5x5 conv of every
    first-order neighbour's group (``NEIGHBORS``), then ReLU; the second
    order runs on the first's output.  mmdet fuses with depthwise 5x5 + 1x1
    chains; these dense pair convs are ``ioudet``'s and have no mmdet
    counterpart;
  * a 2x2 stride-2 transposed conv + GN(36) + ReLU, then another to the 9
    heatmap logits at 56x56 (both dense, as ``ioudet``'s; mmdet's are
    grouped a point).

NCHW; heatmaps (R, 9, 56, 56).  Parameter names: ``convs.{i}.conv`` /
``convs.{i}.gn`` (mmdet's), ``fusion_o1.{j}to{i}`` / ``fusion_o2.{j}to{i}``
(the pair conv from point j's group into point i's), ``deconv1``, ``norm1``
(mmdet's names of the first upsampling and its GN), ``deconv2``.  The
transposed convs are torch's ``ConvTranspose2d``: the bridge flips flax's
kernels (``apis/checkpoint.py``).  GN is flax's (``layers.GroupNorm``, eps
1e-6).

The targets, loss and decode are ``ioudet``'s: a radius-1 disk around each
gt grid point in the (extended) roi's 56x56 raster, BCE over each positive
roi's in-frame points, and each edge the confidence-weighted mean of its
three points' argmax positions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_count
from ..heads.anchor_head import sigmoid
from ..losses.cross_entropy_loss import binary_cross_entropy_with_logits
from ..utils.layers import Conv2d, ConvTranspose2d, GroupNorm, compute_dtype

# first-order neighbours on the 3x3 lattice, row-major point indices
NEIGHBORS = {0: (1, 3), 1: (0, 2, 4), 2: (1, 5), 3: (0, 4, 6), 4: (1, 3, 5, 7),
             5: (2, 4, 8), 6: (3, 7), 7: (4, 6, 8), 8: (5, 7)}
GN_GROUPS = 36


def grid_points_of_box(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 9, 2) xy grid points, row-major (top-left,
    top-centre, top-right, mid-left, ...)."""
    frac = torch.arange(3, dtype=boxes.dtype, device=boxes.device) * 0.5   # 0, 0.5, 1
    fx, fy = frac.repeat(3), frac.repeat_interleave(3)
    x1, y1, x2, y2 = boxes.unbind(-1)
    px = x1[..., None] + (x2 - x1)[..., None] * fx
    py = y1[..., None] + (y2 - y1)[..., None] * fy
    return torch.stack([px, py], dim=-1)


def extend_box(boxes: torch.Tensor, factor: float = 2.0) -> torch.Tensor:
    """Boxes scaled by ``factor`` around their centres (the grid's rois take
    context so that slightly-off boxes still hold every gt point)."""
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    hw = (boxes[..., 2] - boxes[..., 0]) * 0.5 * factor
    hh = (boxes[..., 3] - boxes[..., 1]) * 0.5 * factor
    return torch.stack([cx - hw, cy - hh, cx + hw, cy + hh], dim=-1)


class _ConvGN(nn.Module):
    """3x3 conv with its bias, then GN (``ioudet``'s conv and norm pair)."""

    def __init__(self, cin: int, cout: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Conv2d(cin, cout, 3, padding=1, compute_dtype=dtype)
        self.gn = GroupNorm(GN_GROUPS, cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.gn(self.conv(x)))


class GridHead(nn.Module):
    def __init__(self, grid_points: int = 9, num_convs: int = 8, in_channels: int = 256,
                 point_feat_channels: int = 64, conv_out_channels: int = 576,
                 heatmap_size: int = 56, dtype=None):
        super().__init__()
        if grid_points != len(NEIGHBORS) or conv_out_channels != grid_points * point_feat_channels:
            raise NotImplementedError(
                f"GridHead takes {len(NEIGHBORS)} grid points and conv_out_channels = "
                f"grid_points * point_feat_channels, got {grid_points} and {conv_out_channels}")
        dt = compute_dtype(dtype)
        self.grid_points, self.heatmap_size = grid_points, heatmap_size
        self.point_feat_channels = c = point_feat_channels
        chans = [in_channels] + [conv_out_channels] * num_convs
        self.convs = nn.ModuleList([_ConvGN(chans[i], chans[i + 1], dt)
                                    for i in range(num_convs)])
        for order in ("o1", "o2"):
            self.add_module(f"fusion_{order}", nn.ModuleDict({
                f"{j}to{i}": Conv2d(c, c, 5, padding=2, compute_dtype=dt)
                for i in range(grid_points) for j in NEIGHBORS[i]}))
        self.deconv1 = ConvTranspose2d(conv_out_channels, conv_out_channels, 2, stride=2,
                                       compute_dtype=dt)
        self.norm1 = GroupNorm(GN_GROUPS, conv_out_channels, dtype=dt)
        self.deconv2 = ConvTranspose2d(conv_out_channels, grid_points, 2, stride=2,
                                       compute_dtype=dt)

    def init_weights(self, generator: torch.Generator) -> None:
        """``ioudet``'s (flax's defaults): LeCun normal kernels, zero biases,
        GN at scale 1 and bias 0."""
        with torch.no_grad():
            convs = [m.conv for m in self.convs] + list(self.fusion_o1.values()) + \
                list(self.fusion_o2.values())
            for conv in convs:
                conv.weight.normal_(0.0, conv.weight[0].numel() ** -0.5, generator=generator)
                conv.bias.zero_()
            for deconv in (self.deconv1, self.deconv2):
                fan_in = deconv.weight.shape[0] * deconv.weight.shape[2] * deconv.weight.shape[3]
                deconv.weight.normal_(0.0, fan_in ** -0.5, generator=generator)
                deconv.bias.zero_()

    def fusion(self, x: torch.Tensor, convs: nn.ModuleDict) -> torch.Tensor:
        """One fusion order: point i's group plus the pair convs of its
        neighbours' groups, in ``NEIGHBORS`` order, then ReLU."""
        groups = x.split(self.point_feat_channels, dim=1)
        fused = []
        for i in range(self.grid_points):
            acc = groups[i]
            for j in NEIGHBORS[i]:
                acc = acc + convs[f"{j}to{i}"](groups[j])
            fused.append(F.relu(acc))
        return torch.cat(fused, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """RoI features (R, C, 14, 14) -> heatmap logits (R, 9, 56, 56)."""
        for conv in self.convs:
            x = conv(x)
        x = self.fusion(self.fusion(x, self.fusion_o1), self.fusion_o2)
        x = F.relu(self.norm1(self.deconv1(x)))
        return self.deconv2(x)

    # ------------------------------------------------------------ targets

    def get_targets(self, rois: torch.Tensor, gt_boxes: torch.Tensor, pos_radius: int = 1):
        """rois / gt_boxes (R, 4) on the canvas, the rois already extended.
        Returns (targets (R, 9, S, S) f32, point weights (R, 9): 1 where the
        gt point falls inside the roi's raster)."""
        s = self.heatmap_size
        pts = grid_points_of_box(gt_boxes)
        w = (rois[:, 2] - rois[:, 0])[:, None]
        h = (rois[:, 3] - rois[:, 1])[:, None]
        # the point in heatmap pixels (pixel centres at +0.5)
        gx = (pts[..., 0] - rois[:, 0:1]) / w.clamp(min=1e-6) * s - 0.5
        gy = (pts[..., 1] - rois[:, 1:2]) / h.clamp(min=1e-6) * s - 0.5
        inside = (gx >= 0) & (gx <= s - 1) & (gy >= 0) & (gy <= s - 1)
        xs = torch.arange(s, dtype=torch.float32, device=rois.device)
        d2 = (xs[None, None, :, None] - gy[:, :, None, None]) ** 2 + \
            (xs[None, None, None, :] - gx[:, :, None, None]) ** 2
        return (d2 <= pos_radius ** 2).float(), inside.float()

    @staticmethod
    def loss(heatmap_pred: torch.Tensor, targets: torch.Tensor, point_weights: torch.Tensor,
             pos_mask: torch.Tensor) -> torch.Tensor:
        """BCE of each positive roi's in-frame points, the per-point mean
        over the raster, summed and divided by the weighted point count (the
        global batch's in a process group, at least 1)."""
        bce = binary_cross_entropy_with_logits(heatmap_pred, targets)
        per_pt = bce.mean(dim=(2, 3)) * point_weights
        pos = pos_mask.float()
        count = global_count((point_weights * pos[:, None]).sum()).clamp(min=1.0)
        return (per_pt.sum(-1) * pos).sum() / count

    # ------------------------------------------------------------- decode

    def get_bboxes(self, det_boxes: torch.Tensor, heatmaps: torch.Tensor,
                   extend_factor: float = 2.0) -> torch.Tensor:
        """Refined boxes (N, 4) of det_boxes (N, 4) from the heatmap logits
        (N, 9, S, S) over their extended rois: each point at its argmax
        (the first on ties) and its probability the confidence; each edge
        the confidence-weighted mean of its three points' coordinate."""
        s = self.heatmap_size
        rois = extend_box(det_boxes, extend_factor)
        probs = sigmoid(heatmaps).flatten(2)
        idx = probs.argmax(dim=2)
        conf = torch.gather(probs, 2, idx[..., None])[..., 0]
        py = (idx // s).float() + 0.5
        px = (idx % s).float() + 0.5
        w = (rois[:, 2] - rois[:, 0])[:, None]
        h = (rois[:, 3] - rois[:, 1])[:, None]
        ix = rois[:, 0:1] + px / s * w
        iy = rois[:, 1:2] + py / s * h

        def wavg(vals, pts: slice):
            # the points as a slice: a list index would copy it to the device
            c = conf[:, pts]
            return (vals[:, pts] * c).sum(-1) / c.sum(-1).clamp(min=1e-6)

        # x1 of points 0, 3, 6; y1 of 0, 1, 2; x2 of 2, 5, 8; y2 of 6, 7, 8
        return torch.stack([wavg(ix, slice(0, 9, 3)), wavg(iy, slice(0, 3)),
                            wavg(ix, slice(2, 9, 3)), wavg(iy, slice(6, 9))], dim=-1)
