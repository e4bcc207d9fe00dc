"""One rank of the port's two-process data-parallel job
(tests/test_torch_parallel.py): ranks joined over gloo on the CPU by
``ioudet_torch.parallel.init_dist``, the tiny detector and dataset of
tests/mp_common.py.  No JAX here: the worker imports torch and ioudet_torch
only.

    python tests/_torch_mp_worker.py PORT RANK WORLD INIT_PTH WORK_DIR OUT_PKL
    python tests/_torch_mp_worker.py two_stage PORT RANK WORLD INIT_PTH OUT_PKL

The first form (tests/test_torch_parallel.py) trains 3 steps at ``imgs_per_gpu`` = 2 through ``train_detector``
with a validation hook, evaluates through ``multi_host_test`` (12 images, and
11 for an uneven shard), resumes a second epoch from the checkpoint rank 0
wrote, runs the same two epochs unbroken, and gathers a ragged tree through
``allgather_pytrees``; what it saw goes to OUT_PKL.  The second
(tests/test_torch_two_stage_dp.py) takes ``TWO_STAGE_STEPS`` steps of
the tiny Faster R-CNN (``faster_rcnn_cfgs``) through ``make_train_step`` on
this rank's half of each batch of ``two_stage_batches``, draws the RPN's
anchor sample of the config's ``RandomSampler`` (``rpn_sampled_masks``) on
images that every rank shares, and writes its logged losses, parameters
and sampled masks to OUT_PKL."""

import os
import pickle
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

IMGS_PER_GPU = 2
OPTIMIZER = dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=0.0001)
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=500, warmup_ratio=1.0 / 3,
                 step=[8, 11])
GRAD_CLIP = dict(max_norm=35)


def faster_rcnn_cfgs(num_gts: int = 4, max_num: int = 64) -> tuple:
    """(model, train_cfg, test_cfg) of the tiny Faster R-CNN of
    tests/test_detectors.py with the config's RPN loss (sigmoid CE, anchor
    subsampling).  Sampling takes every candidate whatever the draw: the
    RPN's sampler ``num`` exceeds the anchors of a 64x96 canvas (1536), and
    the R-CNN's is the proposals plus the gts with no cap on positives."""
    model = dict(
        type="FasterRCNN",
        backbone=dict(type="ResNet", depth=18, frozen_stages=1,
                      norm_cfg=dict(type="FrozenBN")),
        neck=dict(type="FPN", in_channels=[64, 128, 256, 512], out_channels=64,
                  num_outs=5),
        rpn_head=dict(type="RPNHead", num_classes=2, in_channels=64, feat_channels=64,
                      anchor_scales=(8,), anchor_ratios=(0.5, 1.0, 2.0),
                      anchor_strides=(4, 8, 16, 32, 64),
                      loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True,
                                    loss_weight=1.0),
                      loss_bbox=dict(type="SmoothL1Loss", beta=1.0 / 9.0, loss_weight=1.0)),
        bbox_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                featmap_strides=(4, 8, 16, 32),
                                roi_layer=dict(out_size=7, sample_num=2)),
        bbox_head=dict(type="SharedFCBBoxHead", num_classes=5, in_channels=64,
                       fc_out_channels=64))
    train = dict(
        rpn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7, neg_iou_thr=0.3,
                               min_pos_iou=0.3, ignore_iof_thr=-1),
                 sampler=dict(type="RandomSampler", num=2048, pos_fraction=0.5,
                              neg_pos_ub=-1, add_gt_as_proposals=False),
                 allowed_border=0, pos_weight=-1),
        rpn_proposal=dict(nms_pre=200, max_num=max_num, nms_thr=0.7),
        rcnn=dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.5,
                                min_pos_iou=0.5),
                  sampler=dict(type="RandomSampler", num=max_num + num_gts,
                               pos_fraction=1.0, add_gt_as_proposals=True),
                  pos_weight=-1))
    test = dict(rpn=dict(nms_pre=200, max_num=max_num, nms_thr=0.7),
                rcnn=dict(score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20))
    return model, train, test


def mask_rcnn_cfgs(num_gts: int = 4, max_num: int = 64) -> tuple:
    """``faster_rcnn_cfgs`` as a Mask R-CNN: the mask branch of
    tests/test_mask_rcnn.py (RoIAlign at 14x14, two 64-wide mask convs)."""
    model, train, test = faster_rcnn_cfgs(num_gts, max_num)
    model = dict(model, type="MaskRCNN",
                 mask_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                         featmap_strides=(4, 8, 16, 32),
                                         roi_layer=dict(out_size=14, sample_num=2)),
                 mask_head=dict(type="FCNMaskHead", num_convs=2, in_channels=64,
                                conv_out_channels=64, num_classes=5))
    return model, train, test


STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1), (0.033, 0.033, 0.067, 0.067))


def cascade_rcnn_cfgs(num_gts: int = 4, max_num: int = 64) -> tuple:
    """``faster_rcnn_cfgs`` as a three-stage Cascade R-CNN (box heads of the
    stages' stds).  Every stage adds the gts to its candidates again, so
    the valid ones grow by the gts a stage (and once more for HTC's
    interleaved mask sample): the training proposals are cut to at most 8
    a level before their NMS (40 of the ``max_num`` slots valid at most), so
    that the sampler's ``num`` (the first stage's candidates, ``max_num +
    num_gts``) holds every valid candidate of every stage, and each stage
    takes them all whatever the draw."""
    model, train, test = faster_rcnn_cfgs(num_gts, max_num)
    head = model["bbox_head"]
    model = dict(model, type="CascadeRCNN", num_stages=3, stage_loss_weights=(1.0, 0.5, 0.25),
                 stage_pos_thrs=(0.5, 0.6, 0.7),
                 bbox_head=[dict(head, target_stds=stds) for stds in STAGE_STDS])
    train["rpn_proposal"]["nms_pre"] = 8
    return model, train, test


def htc_cfgs(interleaved: bool = True, mask_info_flow: bool = True, semantic: bool = True,
             num_gts: int = 4, max_num: int = 64) -> tuple:
    """``cascade_rcnn_cfgs`` as HTC with the three flags: two 64-wide
    ``HTCMaskHead`` convs a stage, and with ``semantic`` a
    ``FusedSemanticHead`` (two convs, 64 wide, 7 classes) and its 14x14
    extractor at stride 8.  All off is Cascade Mask R-CNN."""
    model, train, test = cascade_rcnn_cfgs(num_gts, max_num)
    model = dict(model, type="HybridTaskCascade", interleaved=interleaved,
                 mask_info_flow=mask_info_flow,
                 mask_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                         featmap_strides=(4, 8, 16, 32),
                                         roi_layer=dict(out_size=14, sample_num=2)),
                 mask_head=[dict(type="HTCMaskHead", num_convs=2, in_channels=64,
                                 conv_out_channels=64, num_classes=5)] * 3)
    if semantic:
        model.update(semantic_roi_extractor=dict(type="SingleRoIExtractor", out_channels=64,
                                                 featmap_strides=(8,),
                                                 roi_layer=dict(out_size=14, sample_num=2)),
                     semantic_head=dict(type="FusedSemanticHead", num_ins=5, fusion_level=1,
                                        num_convs=2, in_channels=64, conv_out_channels=64,
                                        num_classes=7, loss_weight=0.2))
    return model, train, test


TWO_STAGE_STEPS = 2


def two_stage_batches(steps: int = TWO_STAGE_STEPS, batch: int = 4, num_gts: int = 4) -> list:
    """Seeded train batches of 64x96 canvases (numpy), the last gt slot of
    each image after the first invalid."""
    rng = np.random.default_rng(21)
    out = []
    for _ in range(steps):
        xy = rng.uniform(0, 50, (batch, num_gts, 2)).astype(np.float32)
        wh = rng.uniform(15, 40, (batch, num_gts, 2)).astype(np.float32)
        valid = np.ones((batch, num_gts), bool)
        valid[1:, -1] = False
        shapes = np.tile(np.array([[64, 96]], np.int32), (batch, 1))
        out.append(dict(img=rng.normal(0, 1, (batch, 64, 96, 3)).astype(np.float32),
                        gt_bboxes=np.concatenate([xy, xy + wh], -1),
                        gt_labels=rng.integers(1, 5, (batch, num_gts)).astype(np.int32),
                        gt_valid=valid, img_shape=shapes, pad_shape=shapes.copy()))
    return out


def two_stage_steps(model, batches: list, rank: int = 0, world: int = 1) -> list:
    """``make_train_step`` over ``batches`` (this rank's share of each),
    SGD at the recipe's settings; returns the logged losses a step."""
    from ioudet_torch.apis import train as ttrain
    sched = ttrain.make_lr_schedule(OPTIMIZER["lr"], LR_CONFIG, 100, 12)
    ttrain.make_trainable_mask(model)
    step = ttrain.make_train_step(model, ttrain.build_optimizer(model, OPTIMIZER), sched,
                                  GRAD_CLIP)
    losses = []
    for i, b in enumerate(batches):
        share = {k: torch.from_numpy(v[rank::world].copy()) for k, v in b.items()}
        losses.append({k: float(v) for k, v in step(share, i).items()})
    return losses


RPN_SAMPLER = dict(type="RandomSampler", num=256, pos_fraction=0.5, neg_pos_ub=-1,
                   add_gt_as_proposals=False)


def rpn_sampled_masks(model, generator: torch.Generator) -> np.ndarray:
    """(B, A) bool: the anchors that the RPN's targets sample with the
    config's ``RandomSampler`` (256 an image) on the first two images of
    ``two_stage_batches``, drawn from ``generator``.  Anchors that cross
    the border count (``allowed_border`` -1): fewer than 256 of a 64x96
    canvas lie inside it, and the sampler would take them all."""
    b = {k: torch.from_numpy(v[:2].copy()) for k, v in two_stage_batches(1)[0].items()}
    with torch.no_grad():
        cls, _ = model.rpn_head(model.extract_feat(b["img"]))
    cfg = dict(faster_rcnn_cfgs()[1]["rpn"], sampler=RPN_SAMPLER, allowed_border=-1)
    _, targets, _ = model.rpn_head._targets(
        [tuple(p.shape[1:3]) for p in cls], b["gt_bboxes"], torch.ones_like(b["gt_labels"]),
        b["gt_valid"], b["img_shape"], b["pad_shape"], cfg, None, None, generator)
    return (targets.label_weights > 0).numpy()


def two_stage_main(port: str, rank: int, world: int, init_path: str, out: str) -> None:
    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    from ioudet_torch.models import build_detector
    from ioudet_torch.parallel import init_dist

    init_dist(device="cpu")
    model = build_detector(*faster_rcnn_cfgs())
    model.load_state_dict(torch.load(init_path, weights_only=True))
    losses = two_stage_steps(model.train(), two_stage_batches(), rank, world)
    from ioudet_torch.apis.train import step_generator
    masks = rpn_sampled_masks(model, step_generator("cpu", 0, 0))
    with open(out, "wb") as f:
        pickle.dump(dict(losses=losses, params=state(model), rpn_masks=masks), f)


def train_cfg(total_epochs: int) -> dict:
    from mp_common import small_detector_cfgs
    model, train_cfg, test_cfg = small_detector_cfgs()
    return dict(model=model, train_cfg=train_cfg, test_cfg=test_cfg, optimizer=OPTIMIZER,
                lr_config=LR_CONFIG, optimizer_config=dict(grad_clip=GRAD_CLIP),
                total_epochs=total_epochs, log_config=dict(interval=1),
                checkpoint_config=dict(interval=1))


def eval_dataset(n: int):
    """TinyDataset with an ``evaluate`` that counts and sums what it got."""
    from mp_common import TinyDataset

    class Counted(TinyDataset):
        def evaluate(self, results):
            return dict(n_results=float(len(results)),
                        score_sum=float(sum(float(r[:, 4].sum()) for per in results
                                            for r in per)))

    return Counted(n)


def new_model(init_path: str):
    from ioudet_torch.models import build_detector
    cfg = train_cfg(1)
    model = build_detector(cfg["model"], cfg["train_cfg"], cfg["test_cfg"])
    model.load_state_dict(torch.load(init_path, weights_only=True))
    return model


def state(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def ragged_tree(rank: int) -> dict:
    if rank == 0:
        return {"a": np.arange(6, dtype=np.float32).reshape(3, 2), "b": np.zeros((0,), np.int64),
                "c": np.int32(7), "d": (np.array([True]), np.ones((2, 2, 3), np.float16))}
    return {"a": np.arange(2, dtype=np.float32).reshape(1, 2) + 10,
            "b": np.arange(10, dtype=np.int64).reshape(2, 5), "c": np.int32(8),
            "d": (np.array([False, True, False]), np.zeros((0,), np.float16))}


def main(port: str, rank: int, world: int, init_path: str, work: str, out: str) -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.dirname(HERE))
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    from mp_common import TinyDataset
    from ioudet_torch.apis.test import multi_host_test
    from ioudet_torch.apis.train import train_detector
    from ioudet_torch.data import build_dataloader
    from ioudet_torch.parallel import allgather_pytrees, init_dist

    device = init_dist(device="cpu")

    def loader():   # this rank's shard of the batches, in dataset order
        return build_dataloader(TinyDataset(), IMGS_PER_GPU, 1, shuffle=False, drop_last=False)

    losses = []
    model = new_model(init_path)
    runner = train_detector(model, loader(), train_cfg(1), os.path.join(work, "run"),
                            device=device, n_devices=world, validate=True,
                            val_dataset=eval_dataset(12),
                            step_hook=lambda s, logs: losses.append(
                                {k: float(v) for k, v in logs.items()}))
    params = state(model)
    results = multi_host_test(model, TinyDataset(), imgs_per_batch=2, workers=1, progress=False)
    uneven = multi_host_test(model, TinyDataset(11), imgs_per_batch=2, workers=1,
                             progress=False)

    resumed = train_detector(new_model(init_path), loader(), train_cfg(2),
                             os.path.join(work, "run"), device=device)
    unbroken = train_detector(new_model(init_path), loader(), train_cfg(2),
                              os.path.join(work, "unbroken"), device=device)
    with open(out, "wb") as f:
        pickle.dump(dict(losses=losses, params=params, steps=runner.step,
                         is_writer=runner.is_writer, results=results, uneven=uneven,
                         resumed_steps=resumed.step,
                         params_resumed=state(resumed.model),
                         params_unbroken=state(unbroken.model),
                         gathered=allgather_pytrees(ragged_tree(rank))), f)


if __name__ == "__main__":
    if sys.argv[1] == "two_stage":
        two_stage_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), *sys.argv[5:7])
    else:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
