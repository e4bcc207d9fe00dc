"""Batched evaluation (counterpart of ``ioudet/apis/test.py``).

``single_device_test`` runs a dataset through ``simple_test`` on the
model's device and returns one ``bbox2result`` list an image, in dataset
order, as ``ioudet``'s does.  Two routes feed it (``eval_batches``):

  * the host pipeline: the dataset's own test pipeline on the loader's
    threads (decode, resize, normalize, pad), each batch pinned and copied
    to the device without a wait;
  * ``device_preprocess=True``: the threads only decode; resize, normalize
    and pad run on the device (``ops/preprocess.py``), with the settings
    read from the dataset's pipeline (``_pipeline_specs``).

Batches hold one orientation each (one canvas).  A group's last batch runs
at its own size: the port compiles nothing, so it need not pad, and the
loader's padding repeats are dropped before the device sees them.

``tta_test`` is the route of a test pipeline that ends in
``MultiScaleFlipAug``.  A single-stage detector's views go through the model
and ``decode_candidates`` one at a time, are mapped back and merged, and one
``multiclass_nms`` an image runs over the union (``aug_test``).  A two-stage
detector's (``aug_test_two_stage``) share one proposal set: each view's
proposals are mapped back and merged by one NMS, every view refines the
merged proposals, the boxes and scores are averaged and go through one
``multiclass_nms``, and a mask detector's masks of the final detections are
averaged over the views: K1 runs views + 2 times an image.

``multi_host_test`` is the data-parallel evaluation: each rank of a
``torch.distributed`` group runs its shard of the batches, the fixed-shape
per-image outputs go through ``allgather_pytrees``, and every rank gets the
whole list.  A two-stage detector serves through the same functions, and
a proposal model's recall is ``make_proposal_recall_hook``'s.  A detector
that ``requires_proposals`` (Fast R-CNN) gets the batch's ``proposals`` and
``prop_valid`` from the host pipeline (``LoadProposals``) after the four
inputs; the device route has no proposals and raises for it.  A mask
detector's results are (bbox list, segm list) pairs: each detection's
box-frame mask pasted into the original image and RLE-encoded on the host
(``masks_to_segm_result``).
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..core.bbox.transforms import bbox2result, bbox_mapping
from ..core.post_processing import (merge_aug_bboxes, merge_aug_bboxes_mean, merge_aug_masks,
                                    merge_aug_proposals, multiclass_nms)
from ..data.loader import build_dataloader, to_device
from ..data.pipelines.loading import imread
from ..ops.preprocess import IMAGENET_MEAN, IMAGENET_STD, preprocess_batch
from ..parallel.mesh import allgather_pytrees, rank, world_size

logger = logging.getLogger(__name__)

INPUT_KEYS = ("img", "img_shape", "scale_factor", "pad_shape")
PROPOSAL_KEYS = ("proposals", "prop_valid")   # a Fast R-CNN's, from LoadProposals


def _pipeline_specs(dataset):
    """(canvas, max_scale, mean, std, to_rgb, keep_ratio) of the dataset's
    test pipeline, so that the device route reproduces it; ``ioudet``'s
    defaults where a step is absent."""
    canvas, max_scale, keep_ratio = (832, 1344), (1333, 800), True
    mean, std, to_rgb = IMAGENET_MEAN, IMAGENET_STD, True
    for step in dataset.pipeline.transforms:
        name = type(step).__name__
        if name == "Resize":
            max_scale, keep_ratio = tuple(step.img_scale[0]), step.keep_ratio
        elif name == "Pad" and step.size:
            canvas = tuple(step.size)
        elif name == "Normalize":
            mean, std = tuple(step.mean), tuple(step.std)
            to_rgb = bool(step.to_rgb)
    return canvas, max_scale, mean, std, to_rgb, keep_ratio


def _host_batches(dataset, device, imgs_per_batch, workers, num_shards, shard_index):
    loader = build_dataloader(dataset, imgs_per_batch, workers, shuffle=False,
                              drop_last=False, num_shards=num_shards,
                              shard_index=shard_index)
    seen = set()
    for batch in loader:
        idx = [int(i) for i in batch["idx"]]
        # unshuffled, a group's indices rise, and the loader fills its last
        # batch with the group's first images again: cut the batch where it
        # stops rising, so that every image runs in the batch it has in one
        # shard (results bit-equal across shard counts); then drop what this
        # shard ran already (a shard's padding batches)
        rising = next((b for b in range(1, len(idx)) if idx[b] <= idx[b - 1]), len(idx))
        keep = [b for b in range(rising) if idx[b] not in seen]
        if not keep:
            continue
        seen.update(idx[b] for b in keep)
        sel = slice(None) if len(keep) == len(idx) else np.asarray(keep)
        ori = batch.get("ori_shape", batch["img_shape"])[sel]
        keys = INPUT_KEYS + (PROPOSAL_KEYS if "proposals" in batch else ())
        yield [idx[b] for b in keep], tuple(to_device(batch[k][sel], device)
                                            for k in keys), ori


def _device_batches(dataset, device, imgs_per_batch, workers, num_shards, shard_index):
    canvas, max_scale, mean, std, to_rgb, keep_ratio = _pipeline_specs(dataset)
    infos = dataset.img_infos
    # one raw buffer shape for the dataset (ioudet's bucket): the largest
    # image rounded up to 256
    bh = max(256, -(-max(i["height"] for i in infos) // 256) * 256)
    bw = max(256, -(-max(i["width"] for i in infos) // 256) * 256)
    land = [i for i, info in enumerate(infos) if info["width"] >= info["height"]]
    port = [i for i, info in enumerate(infos) if info["width"] < info["height"]]
    portrait = (canvas[1], canvas[0]) if canvas[0] < canvas[1] else canvas
    jobs = [(group[s:s + imgs_per_batch], cv)
            for group, cv in ((land, canvas), (port, portrait))
            for s in range(0, len(group), imgs_per_batch)][shard_index::num_shards]
    pin = device.type == "cuda"
    with ThreadPoolExecutor(max(1, workers)) as pool:
        def submit(job):
            return [pool.submit(imread, os.path.join(dataset.img_prefix,
                                                     infos[i]["filename"]))
                    for i in job[0]]

        pending = submit(jobs[0]) if jobs else []
        for j, (idxs, cv) in enumerate(jobs):
            decoded = [f.result() for f in pending]
            # decode the next batch while this one is on the device
            pending = submit(jobs[j + 1]) if j + 1 < len(jobs) else []
            raw = torch.zeros((len(idxs), bh, bw, 3), dtype=torch.uint8, pin_memory=pin)
            shapes = np.empty((len(idxs), 2), np.int32)
            for b, arr in enumerate(decoded):
                h, w = arr.shape[:2]
                raw.numpy()[b, :h, :w] = arr
                shapes[b] = h, w
            imgs, img_shapes, factors = preprocess_batch(
                raw.to(device, non_blocking=True), to_device(shapes, device),
                canvas=cv, max_scale=max_scale, mean=mean, std=std, flip_channels=to_rgb,
                keep_ratio=keep_ratio)
            pad_shapes = np.tile(np.asarray([cv], np.int32), (len(idxs), 1))
            yield idxs, (imgs, img_shapes, factors, to_device(pad_shapes, device)), shapes


def eval_batches(dataset, device, imgs_per_batch: int = 8, workers: int = 4,
                 device_preprocess: bool = False, num_shards: int = 1, shard_index: int = 0,
                 with_ori_shape: bool = False
                 ) -> Iterator[Tuple[List[int], Tuple[torch.Tensor, ...]]]:
    """The evaluation loop's batches on ``device``: (dataset indices, (imgs
    (B, H, W, 3) f32 canvas, img_shapes (B, 2), scale_factors (B,) or (B, 4),
    pad_shapes (B, 2))), one orientation a batch; every image once, or with
    ``num_shards`` > 1 the ``shard_index``-th share of the batches (an image
    may then come again in another shard); a pipeline with
    ``LoadProposals`` adds (proposals (B, P, 4), prop_valid (B, P)) to the
    inputs.  ``with_ori_shape`` adds the
    images' decoded (h, w), (B, 2) int32 numpy, as a third item."""
    device = torch.device(device)
    if device_preprocess and any(type(t).__name__ == "LoadProposals"
                                 for t in dataset.pipeline.transforms):
        raise NotImplementedError("device_preprocess has no proposal route: a pipeline with "
                                  "LoadProposals runs on the host")
    route = _device_batches if device_preprocess else _host_batches
    batches = route(dataset, device, imgs_per_batch, workers, num_shards, shard_index)
    if with_ori_shape:
        return ((idxs, inputs, np.asarray(ori, np.int32)) for idxs, inputs, ori in batches)
    return ((idxs, inputs) for idxs, inputs, _ in batches)


def masks_to_segm_result(dets: np.ndarray, labels: np.ndarray, mask_probs: np.ndarray,
                         num_classes: int, ori_h: int, ori_w: int) -> List[list]:
    """One image's per-class lists of RLE dicts: each detection's box-frame
    mask probabilities (dets in original-image coordinates) pasted into the
    (ori_h, ori_w) image and encoded (``rle.encode_pasted``).  Rows with label
    >= 0 are kept, in order, as ``bbox2result`` keeps them, so that segm
    row i of a class is bbox row i."""
    from ..core.mask import rle

    segm: List[list] = [[] for _ in range(num_classes - 1)]
    for i in range(dets.shape[0]):
        lab = int(labels[i])
        if lab >= 0:
            segm[lab].append(rle.encode_pasted(dets[i, :4], mask_probs[i], ori_h, ori_w))
    return segm


def to_results(raw: tuple, num_classes: int):
    """One image's fixed-shape outputs (dets, labels[, mask probs, ori
    shape]) -> its ``bbox2result`` list, or (bbox list, segm list)."""
    bbox_res = bbox2result(raw[0], raw[1], num_classes)
    if len(raw) == 2:
        return bbox_res
    ori = raw[3]
    return bbox_res, masks_to_segm_result(raw[0], raw[1], raw[2], num_classes,
                                          int(ori[0]), int(ori[1]))


@torch.inference_mode()
def single_device_test(handle, dataset, imgs_per_batch: int = 8, workers: int = 4,
                       progress: bool = True, device_preprocess: bool = False,
                       return_raw: bool = False, num_shards: int = 1,
                       shard_index: int = 0):
    """handle: a ``DetectorHandle`` or a detector; runs on its device.
    Returns one list of ``num_classes - 1`` (k, 5) float32 arrays an image,
    in dataset order; for a mask detector one (that list, the per-class
    lists of RLE dicts) pair an image.

    ``return_raw=True`` returns ``{dataset index: (dets (max_per_img, 5),
    labels (max_per_img,)[, mask probs (max_per_img, 28, 28), ori_shape
    (2,)])}`` numpy arrays instead, for the images of shard ``shard_index``
    of ``num_shards`` (the whole dataset by default): the fixed shapes that
    ``multi_host_test`` gathers."""
    model = getattr(handle, "model", handle)
    device = next(model.parameters()).device
    num_classes = model.num_result_classes
    results: dict = {}
    t0 = time.perf_counter()
    for n, (idxs, inputs, ori) in enumerate(eval_batches(
            dataset, device, imgs_per_batch, workers, device_preprocess, num_shards,
            shard_index, with_ori_shape=True)):
        outs = [o.cpu().numpy() for o in model.simple_test(*inputs)]
        for b, i in enumerate(idxs):
            raw = tuple(o[b] for o in outs) + ((ori[b],) if len(outs) > 2 else ())
            results[i] = raw if return_raw else to_results(raw, num_classes)
        if progress and (n + 1) % 20 == 0:
            logger.info("eval %d/%d (%.1f img/s%s)", len(results), len(dataset),
                        len(results) / (time.perf_counter() - t0),
                        ", device preprocess" if device_preprocess else "")
    if return_raw:
        return results
    if len(results) != len(dataset):
        raise RuntimeError(f"evaluated {len(results)} of {len(dataset)} images")
    return [results[i] for i in range(len(dataset))]


def multi_host_test(handle, dataset, imgs_per_batch: int = 8, workers: int = 4,
                    progress: bool = True, device_preprocess: bool = False) -> list:
    """``single_device_test`` over the ranks of a ``torch.distributed``
    group: each rank runs its shard of the batches, the per-image
    ``(dets (max_per_img, 5), labels (max_per_img,))`` (a mask detector's
    with the mask probabilities and original shapes) and the image indices
    go through ``allgather_pytrees``, the loader's repeats are dropped (the
    first copy is kept), then the results are made (the masks pasted and
    encoded), and every rank returns the whole list in dataset order.  One
    rank: ``single_device_test``."""
    n = world_size()
    if n == 1:
        return single_device_test(handle, dataset, imgs_per_batch, workers, progress,
                                  device_preprocess)
    raw = single_device_test(handle, dataset, imgs_per_batch, workers, progress,
                             device_preprocess, return_raw=True, num_shards=n,
                             shard_index=rank())
    model = getattr(handle, "model", handle)
    dtypes = (np.float32, np.int64) + \
        ((np.float32, np.int32) if getattr(model, "mask_head", None) is not None else ())
    idxs = np.asarray(sorted(raw), np.int64)
    if len(idxs):
        fields = tuple(np.stack([raw[i][f] for i in idxs]).astype(dt)
                       for f, dt in enumerate(dtypes))
    else:   # an empty shard: the trailing shapes come from a peer
        fields = tuple(np.zeros((0,), dt) for dt in dtypes)
    num_classes = model.num_result_classes
    merged: dict = {}
    for shard in allgather_pytrees((idxs,) + fields):
        for j, i in enumerate(shard[0].tolist()):
            if i not in merged:
                merged[i] = to_results(tuple(f[j] for f in shard[1:]), num_classes)
    if sorted(merged) != list(range(len(dataset))):
        raise RuntimeError(f"the ranks evaluated {len(merged)} of {len(dataset)} images")
    return [merged[i] for i in range(len(dataset))]


@torch.inference_mode()
def aug_test(handle, samples: List[dict], test_cfg: Optional[dict] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale / flip TTA of one image, single-stage: ``samples`` are its
    ``MultiScaleFlipAug`` views (img, img_shape, scale_factor, flip).
    Returns (dets (max_per_img, 5), labels (max_per_img,)), label -1 padding,
    on the model's device.

    As ``ioudet``'s merge, the one NMS takes only ``score_thr``, the NMS
    ``iou_thr`` and ``max_per_img`` from ``test_cfg``: ``pre_nms_total``
    stays 2000 and ``class_topk`` unset whatever the config says."""
    model = getattr(handle, "model", handle)
    if getattr(type(model.bbox_head), "TTA", True) is False:
        raise NotImplementedError(f"the multi-scale / flip test of "
                                  f"{type(model.bbox_head).__name__} is not ported yet")
    device = next(model.parameters()).device
    cfg = dict(model.test_cfg or {}) if test_cfg is None else dict(test_cfg)
    boxes, scores, metas = [], [], []
    for s in samples:
        img, img_shape, _, meta = view_inputs(s, device)
        b, sc = model.bbox_head.decode_candidates(*model(img), img_shape[None], cfg)
        boxes.append(b[0])
        scores.append(sc[0])
        metas.append(meta)
    merged_boxes, merged_scores = merge_aug_bboxes(boxes, scores, metas)
    dets, labels = multiclass_nms(merged_boxes[None], merged_scores[None],
                                  score_thr=cfg.get("score_thr", 0.05),
                                  iou_thr=cfg.get("nms", {}).get("iou_thr", 0.5),
                                  max_per_img=cfg.get("max_per_img", 100))
    return dets[0], labels[0]


def view_inputs(sample: dict, device) -> tuple:
    """A ``MultiScaleFlipAug`` view's (img (1, H, W, 3) f32, img_shape (2,),
    pad_shape (2,), meta dict(img_shape, scale_factor, flip)) on ``device``;
    the scale factor a 0-d tensor (the map back divides by it)."""
    img = torch.from_numpy(np.ascontiguousarray(sample["img"], np.float32))[None].to(device)
    shape = torch.from_numpy(np.asarray(sample["img_shape"], np.int32)).to(device)
    pad = torch.from_numpy(np.asarray(sample.get("pad_shape", sample["img_shape"]),
                                      np.int32)).to(device)
    factor = torch.from_numpy(np.asarray(sample["scale_factor"], np.float32)).to(device)
    return img, shape, pad, dict(img_shape=shape, scale_factor=factor, flip=bool(sample["flip"]))


@torch.inference_mode()
def aug_test_two_stage(handle, samples: List[dict], test_cfg: Optional[dict] = None) -> tuple:
    """Multi-scale / flip TTA of one image, two-stage (``ioudet``'s
    ``aug_test_two_stage``; mmdet's ``aug_test_bboxes`` and
    ``aug_test_mask``):

      1. each view's RPN proposals (``test_proposals`` by the model's
         ``test_cfg.rpn``) mapped back and merged by ``merge_aug_proposals``
         (``test_cfg.rpn``'s ``nms_thr`` and ``max_num``);
      2. the merged proposals mapped into each view, scored and refined
         there without an NMS (``rcnn_test_raw``), mapped back and averaged
         (``merge_aug_bboxes_mean``), then one ``multiclass_nms`` by
         ``test_cfg.rcnn`` with the merged padding rows kept out;
      3. a detector with ``mask_test_boxes`` (Mask R-CNN and Mask Scoring
         R-CNN) runs its mask branch in each view on the final detections
         mapped into it, and the probabilities are averaged
         (``merge_aug_masks``).

    The primitives are the ones ``ioudet`` calls: Mask Scoring R-CNN is not
    rescored here and Grid R-CNN not refined, and HTC's are the cascade's
    (no semantic feature, boxes only).  The backbone runs once a view
    (``ioudet`` runs it in each primitive, to the same result).  Returns
    (dets (max_per_img, 5), labels (max_per_img,)[, masks (max_per_img, 28,
    28)]) on the model's device, in original-image coordinates."""
    model = getattr(handle, "model", handle)
    if getattr(model, "requires_proposals", False):
        raise NotImplementedError(
            f"{type(model).__name__} reads its proposals from a file: the two-stage TTA "
            "merges each view's RPN proposals, and a detector without an RPN has no TTA")
    device = next(model.parameters()).device
    cfg = dict(model.test_cfg or {}) if test_cfg is None else dict(test_cfg)
    rpn_cfg = dict(cfg.get("rpn", dict(nms_pre=1000, max_num=1000, nms_thr=0.7)))
    rcnn_cfg = dict(cfg.get("rcnn", dict(score_thr=0.05, nms=dict(iou_thr=0.5),
                                         max_per_img=100)))
    feats, metas, props = [], [], []
    for s in samples:
        img, shape, pad, meta = view_inputs(s, device)
        feats.append(model.extract_feat(img))
        props.append(model.test_proposals(feats[-1], shape[None], pad[None])[0])
        metas.append(meta)
    merged = merge_aug_proposals(props, metas, rpn_cfg)
    boxes, scores = [], []
    for f, meta in zip(feats, metas):
        view_boxes = bbox_mapping(merged[:, :4], meta["img_shape"], meta["scale_factor"],
                                  meta["flip"])
        sc, bx = model.rcnn_test_raw(f, view_boxes[None], meta["img_shape"][None])
        scores.append(sc[0])
        boxes.append(bx[0])
    mboxes, mscores = merge_aug_bboxes_mean(boxes, scores, metas)
    num, classes = mscores.shape
    dets, labels = multiclass_nms(mboxes.reshape(1, num, classes * 4), mscores[None],
                                  score_thr=rcnn_cfg.get("score_thr", 0.05),
                                  iou_thr=rcnn_cfg.get("nms", {}).get("iou_thr", 0.5),
                                  max_per_img=rcnn_cfg.get("max_per_img", 100),
                                  valid=(merged[:, 4] > 0)[None])
    if not hasattr(model, "mask_test_boxes"):
        return dets[0], labels[0]
    masks = [model.mask_test_boxes(f, bbox_mapping(dets[:, :, :4], meta["img_shape"],
                                                   meta["scale_factor"], meta["flip"]),
                                   labels)[0]
             for f, meta in zip(feats, metas)]
    return dets[0], labels[0], merge_aug_masks(masks, metas)


def tta_test(handle, dataset, test_cfg: Optional[dict] = None) -> list:
    """``aug_test`` (single-stage) or ``aug_test_two_stage`` over a dataset
    whose test pipeline ends in ``MultiScaleFlipAug`` (each item a list of
    views), on the model's device.  Returns one ``bbox2result`` list an
    image, in dataset order; for a mask detector one (that list, the
    per-class lists of RLE dicts) pair an image, the masks pasted into the
    original image."""
    model = getattr(handle, "model", handle)
    num_classes = model.num_result_classes
    two_stage = hasattr(model, "rcnn_test_raw")
    results = []
    for idx in range(len(dataset)):
        views = dataset[idx]
        if not isinstance(views, list):
            raise TypeError("tta_test needs a test pipeline that ends in MultiScaleFlipAug")
        out = (aug_test_two_stage if two_stage else aug_test)(model, views, test_cfg)
        raw = tuple(o.cpu().numpy() for o in out)
        if len(raw) > 2:
            raw += (np.asarray(views[0].get("ori_shape", views[0]["img_shape"]))[:2],)
        results.append(to_results(raw, num_classes))
    return results


def make_proposal_recall_hook(val_dataset, proposal_nums=(100, 300, 1000), iou_thrs=(0.5,),
                              imgs_per_batch: int = 8) -> Callable:
    """``hook(model) -> {"AR@N": recall}`` of a proposal model (``RPN``):
    ``single_device_test`` of ``val_dataset``, then the recall of each
    image's top N proposals against its gt boxes (``eval_recalls``)."""
    from ..core.evaluation import eval_recalls

    def hook(model):
        results = single_device_test(model, val_dataset, imgs_per_batch=imgs_per_batch,
                                     progress=False)
        gts = [val_dataset.get_ann_info(i)["bboxes"] for i in range(len(val_dataset))]
        props = [np.concatenate(r) if len(r) else np.zeros((0, 5), np.float32)
                 for r in results]
        recalls = eval_recalls(gts, props, proposal_nums, iou_thrs)
        return {f"AR@{n}": float(recalls[i, 0]) for i, n in enumerate(proposal_nums)}

    return hook


def make_eval_hook(val_dataset, imgs_per_batch: int = 8) -> Callable:
    """``hook(model) -> metrics``: ``multi_host_test`` on ``val_dataset``
    (every rank sees the whole merged list), then its ``evaluate`` (the
    train loop's validation)."""
    def hook(model):
        results = multi_host_test(model, val_dataset, imgs_per_batch=imgs_per_batch,
                                  progress=False)
        return val_dataset.evaluate(results) if hasattr(val_dataset, "evaluate") else {}

    return hook
