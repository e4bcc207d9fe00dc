"""The port's evaluation modules (ioudet_torch/core/evaluation) against
ioudet's on the CPU: the hand-derived goldens of
tests/test_coco_eval_golden.py rerun on the port's CocoEvaluator, and
CocoEvaluator, eval_map, eval_recalls and bbox_overlaps_np of both packages
on the same seeded detections and gts (crowd and ignored gts, empty images,
classes without a gt, dets on IoU thresholds), equal bit for bit."""

import numpy as np
import pytest

import tests.test_coco_eval_golden as golden
from ioudet.core import evaluation as J
from ioudet_torch.core import evaluation as P
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

GOLDENS = [getattr(golden, name) for name in sorted(dir(golden)) if name.startswith("test_")]


@pytest.mark.parametrize("case", GOLDENS, ids=lambda f: f.__name__)
def test_hand_goldens(case, monkeypatch):
    monkeypatch.setattr(golden, "CocoEvaluator", P.CocoEvaluator)
    case()


def random_boxes(rng, n, size=200.0):
    xy = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(2, 90, (n, 2))
    return np.concatenate([xy, xy + wh], 1)


def make_case(seed, num_imgs=12, num_cats=5):
    """Per image: gt dicts (xywh, some crowd, some ignore, some with an area
    other than w * h) and per-class (n, 5) f32 dets, many of them jittered
    copies of gts, a few exact; images and classes without any."""
    rng = np.random.default_rng(seed)
    cat_ids = [3, 7, 8, 20, 41][:num_cats]
    gts, dets = [], []
    for i in range(num_imgs):
        n_gt = 0 if i % 5 == 4 else int(rng.integers(1, 8))
        boxes = random_boxes(rng, n_gt)
        cats = rng.choice(cat_ids[:-1], n_gt)   # the last category has no gt
        anns = []
        for b, c in zip(boxes, cats):
            w, h = b[2] - b[0], b[3] - b[1]
            ann = dict(bbox=[float(b[0]), float(b[1]), float(w), float(h)],
                       category_id=int(c), iscrowd=int(rng.uniform() < 0.15))
            if rng.uniform() < 0.1:
                ann["ignore"] = True
            if rng.uniform() < 0.3:
                ann["area"] = float(w * h * rng.uniform(0.3, 1.0))
            anns.append(ann)
        gts.append(anns)
        per_cls = []
        for ci, c in enumerate(cat_ids):
            own = [a["bbox"] for a in anns if a["category_id"] == c]
            rows = []
            for x, y, w, h in own:
                for _ in range(int(rng.integers(0, 3))):
                    jit = rng.normal(0, 4, 4) * (rng.uniform() < 0.8)
                    rows.append([x + jit[0], y + jit[1], x + w - 1 + jit[2], y + h - 1 + jit[3]])
            rows += random_boxes(rng, int(rng.integers(0, 4))).tolist()
            if i == 7:
                rows = []   # an image without detections
            d = np.zeros((len(rows), 5), np.float32)
            if rows:
                d[:, :4] = rows
                d[:, 4] = rng.choice([0.3, 0.5, 0.9], len(rows)) if ci == 1 \
                    else rng.uniform(0.05, 1, len(rows))   # ties in one class
            per_cls.append(d)
        dets.append(per_cls)
    return cat_ids, gts, dets


def evaluate(mod, cat_ids, gts, dets):
    ev = mod.CocoEvaluator(cat_ids)
    for i, g in enumerate(gts):
        ev.add_gt(100 + i, g)
    for i, d in enumerate(dets):
        ev.add_det_per_class(100 + i, d)
    return ev.evaluate(), ev


@pytest.mark.parametrize("seed", range(6))
def test_coco_evaluator_equals_ioudet(seed):
    cat_ids, gts, dets = make_case(seed)
    ours, ev_ours = evaluate(P, cat_ids, gts, dets)
    ref, ev_ref = evaluate(J, cat_ids, gts, dets)
    assert ours == ref
    np.testing.assert_array_equal(ev_ours.precision, ev_ref.precision)
    np.testing.assert_array_equal(ev_ours.recall, ev_ref.recall)
    assert 0 < ours["AP50"] < 1, ours   # neither trivial nor perfect


def test_matching_on_thresholds_rounds_ious_as_ioudet():
    """IoUs on a threshold: det and gt built so that IoU = 0.55, 0.6, ...
    up to f64 rounding; the match decides each on the f32-rounded value,
    as ioudet's native matcher does."""
    gts, dets = [], []
    for i, t in enumerate(np.linspace(0.5, 0.95, 10)):
        # a w x 10 gt; a det shifted along x with overlap o: IoU = o / (2w - o)
        w = 100.0
        o = 2 * w * t / (1 + t)
        gts.append([dict(bbox=[0.0, 0.0, w, 10.0], category_id=1, iscrowd=0)])
        dets.append([np.array([[w - o, 0, 2 * w - o - 1, 9, 0.9]], np.float32)])
    ours, ev_ours = evaluate(P, [1], gts, dets)
    ref, ev_ref = evaluate(J, [1], gts, dets)
    assert ours == ref
    np.testing.assert_array_equal(ev_ours.precision, ev_ref.precision)


def test_coco_eval_results_and_summary():
    cat_ids, gts, dets = make_case(11)
    ids = list(range(len(gts)))
    ours = P.coco_eval_results(dets, gts, ids, cat_ids)
    assert ours == J.coco_eval_results(dets, gts, ids, cat_ids)
    assert P.print_coco_summary(ours) == J.print_coco_summary(ours)


def test_too_many_classes_raise():
    ev = P.CocoEvaluator([1])
    with pytest.raises(ValueError, match="foreground classes"):
        ev.add_det_per_class(0, [np.zeros((0, 5), np.float32)] * 2)


def voc_case(seed, num_imgs=10, num_classes=4):
    rng = np.random.default_rng(seed)
    dets, boxes, labels, ignore = [], [], [], []
    for i in range(num_imgs):
        n = 0 if i == 3 else int(rng.integers(1, 7))
        b = random_boxes(rng, n).astype(np.float32)
        lab = rng.integers(1, num_classes, n)   # class num_classes has no gt
        boxes.append(b)
        labels.append(lab)
        ignore.append(rng.uniform(size=n) < 0.15)
        per_cls = []
        for c in range(num_classes):
            own = b[lab == c + 1]
            rows = [bb + rng.normal(0, 3, 4) for bb in own for _ in range(int(rng.integers(0, 3)))]
            rows += random_boxes(rng, int(rng.integers(0, 3))).tolist()
            d = np.zeros((len(rows), 5), np.float32)
            if rows:
                d[:, :4] = rows
                d[:, 4] = rng.uniform(0.05, 1, len(rows))
            per_cls.append(d)
        dets.append(per_cls)
    return dets, boxes, labels, ignore


@pytest.mark.parametrize("mode", ["area", "11points"])
@pytest.mark.parametrize("seed", range(3))
def test_eval_map_equals_ioudet(seed, mode):
    dets, boxes, labels, ignore = voc_case(seed)
    for ig in (None, ignore):
        ours = P.eval_map(dets, boxes, labels, ig, mode=mode)
        ref = J.eval_map(dets, boxes, labels, ig, mode=mode)
        assert ours == ref
    assert P.print_map_summary(*ours, dataset="voc") == J.print_map_summary(*ref, dataset="voc")


@pytest.mark.parametrize("seed", range(3))
def test_eval_recalls_equals_ioudet(seed):
    dets, boxes, _, _ = voc_case(seed)
    props = [np.concatenate(d) for d in dets]
    props[2] = props[2][:, :4]   # proposals without scores
    for nums, thrs in (((1, 5, 100), None), ((3, 10), (0.5, 0.7, 0.9))):
        np.testing.assert_array_equal(P.eval_recalls(boxes, props, nums, thrs),
                                      J.eval_recalls(boxes, props, nums, thrs))


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_equals_ioudet(mode):
    rng = np.random.default_rng(5)
    a, b = random_boxes(rng, 30).astype(np.float32), random_boxes(rng, 17).astype(np.float32)
    np.testing.assert_array_equal(P.bbox_overlaps_np(a, b, mode), J.bbox_overlaps_np(a, b, mode))
    assert P.bbox_overlaps_np(a[:0], b, mode).shape == (0, 17)


def test_class_names():
    assert P.get_classes("coco") == J.get_classes("coco")
    assert P.get_classes("voc") == J.get_classes("voc")
    with pytest.raises(KeyError):
        P.get_classes("nope")
