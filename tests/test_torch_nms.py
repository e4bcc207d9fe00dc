"""Port parity: the greedy NMS of ioudet_torch (plain forms of the CUDA
kernels, ops/nms.py, multiclass_nms) against ioudet's suppression_matrix and
greedy_keep_pallas (Pallas in interpret mode on the CPU), greedy_suppress and
multiclass_nms.  Keep masks, mask bits and NMS outputs are compared exactly:
the selection is a sequence of comparisons on bit-equal IoUs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import nms_cases
from ioudet.core.bbox.geometry import bbox_overlaps as jax_overlaps
from ioudet.core.post_processing import multiclass_nms as jax_multiclass_nms
from ioudet.ops.nms import greedy_suppress as jax_greedy_suppress
from ioudet.ops.nms import nms as jax_nms
from ioudet.ops.nms_pallas import greedy_keep_pallas, suppression_matrix
from ioudet_torch.core.bbox import bbox_overlaps
from ioudet_torch.core.post_processing import multiclass_nms
from ioudet_torch.ops import nms as tnms
from ioudet_torch.ops import nms_cuda
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def _cases(n):
    """ioudet's kernels take one image: two images of each case."""
    for name, boxes, valid in nms_cases(n, 2, seed=n):
        for i in range(2):
            yield f"{name}[{i}]", boxes[i], valid[i]


@pytest.mark.parametrize("n", [63, 65, 200])
def test_keep_matches_ioudet(n):
    """Plain mask + reduce (the kernels' CPU form) == greedy_keep_pallas ==
    greedy_suppress, on chains, duplicates, invalid slots, class-offset
    coordinates and IoU exactly at the threshold, N not a multiple of 128."""
    for name, b, v in _cases(n):
        keep = nms_cuda.greedy_keep(torch.from_numpy(b)[None],
                                    torch.from_numpy(v)[None], 0.5)[0].numpy()
        jb, jv = jnp.asarray(b), jnp.asarray(v)
        ref = np.asarray(jax_greedy_suppress(jax_overlaps(jb, jb), jv, 0.5))
        np.testing.assert_array_equal(keep, ref, err_msg=name)
        np.testing.assert_array_equal(
            keep, np.asarray(greedy_keep_pallas(jb, jv, 0.5)), err_msg=name)


@pytest.mark.parametrize("n", [64, 130])
def test_mask_bits_match_suppression_matrix(n):
    for name, b, _ in _cases(n):
        pad = -(-n // 128) * 128
        bp = np.zeros((pad, 4), np.float32)
        bp[:n] = b
        ref = np.asarray(suppression_matrix(jnp.asarray(bp), 0.5))[:n, :n]
        out = nms_cuda.suppression_matrix(torch.from_numpy(b), 0.5).numpy()
        np.testing.assert_array_equal(out, ref, err_msg=name)


def test_threshold_case_is_not_suppressed():
    """IoU exactly 0.5 never suppresses (strict >), at any offset."""
    _, b, v = nms_cases(8, 1)[-1]
    keep = nms_cuda.greedy_keep(torch.from_numpy(b), torch.from_numpy(v), 0.5)
    assert bool(keep.all())
    iou = bbox_overlaps(torch.from_numpy(b[0, :2]), torch.from_numpy(b[0, :2]))
    assert float(iou[0, 1]) == 0.5


@pytest.mark.parametrize("n", [1, 40, 97])
def test_plain_greedy_forms_agree(n):
    """ops.nms: fixed point == sequential oracle == ioudet.greedy_suppress."""
    for name, b, v in _cases(n):
        iou = bbox_overlaps(torch.from_numpy(b), torch.from_numpy(b))
        tv = torch.from_numpy(v)
        fixed = tnms.greedy_suppress(iou, tv, 0.5)
        np.testing.assert_array_equal(
            fixed.numpy(), tnms.greedy_suppress_sequential(iou, tv, 0.5).numpy())
        jb = jnp.asarray(b)
        ref = jax_greedy_suppress(jax_overlaps(jb, jb), jnp.asarray(v), 0.5)
        np.testing.assert_array_equal(fixed.numpy(), np.asarray(ref), err_msg=name)


def test_nms_matches_ioudet():
    rng = np.random.default_rng(5)
    _, b, v = nms_cases(90, 1, seed=3)[0]
    scores = rng.uniform(0, 1, 90).astype(np.float32)
    scores[10:20] = scores[0]  # ties: lower index first
    d, k, o = tnms.nms(torch.from_numpy(b[0]), torch.from_numpy(scores), 0.5,
                       torch.from_numpy(v[0]))
    jd, jk, jo = jax_nms(jnp.asarray(b[0]), jnp.asarray(scores), 0.5,
                          jnp.asarray(v[0]))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def _candidates(seed, b=2, n=150, c=7, per_class=False):
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(20, 300, (b, n, 2))
    wh = rng.uniform(10, 80, (b, n, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    if per_class:
        jitter = rng.uniform(-3, 3, (b, n, c, 4))
        boxes = (boxes[:, :, None, :] + jitter).reshape(b, n, c * 4)
    scores = rng.uniform(0, 1, (b, n, c)) * (rng.uniform(size=(b, n, c)) < 0.3)
    scores[:, 5:15] = scores[:, 4:5]  # score ties across anchors
    return boxes.astype(np.float32), scores.astype(np.float32)


@pytest.mark.parametrize("class_topk", [4, None])
@pytest.mark.parametrize("per_class,nms_type", [(False, "nms"), (True, "nms"),
                                                (False, "pallas_greedy")])
def test_multiclass_nms_matches_ioudet(class_topk, per_class, nms_type):
    boxes, scores = _candidates(11, per_class=per_class)
    factors = np.random.default_rng(12).uniform(0.5, 1, scores.shape[:2])
    factors = factors.astype(np.float32)
    kw = dict(score_thr=0.05, iou_thr=0.5, max_per_img=40, pre_nms_total=300,
              class_topk=class_topk, nms_type=nms_type)
    dets, labels = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  score_factors=torch.from_numpy(factors), **kw)
    assert tuple(dets.shape) == (2, 40, 5) and tuple(labels.shape) == (2, 40)
    assert int((labels >= 0).sum()) > 10
    for i in range(2):
        jd, jl = jax_multiclass_nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                                    score_factors=jnp.asarray(factors[i]), **kw)
        np.testing.assert_array_equal(dets[i].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))


def test_multiclass_nms_pads_small_inputs():
    boxes, scores = _candidates(13, n=6, c=3)
    dets, labels = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                  score_thr=0.05, max_per_img=30)
    jd, jl = jax_multiclass_nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                score_thr=0.05, max_per_img=30)
    np.testing.assert_array_equal(dets[0].numpy(), np.asarray(jd))
    np.testing.assert_array_equal(labels[0].numpy(), np.asarray(jl))


@pytest.mark.parametrize("kw,err", [
    (dict(nms_type="matrix"), NotImplementedError),
    (dict(nms_type="soft_nms"), NotImplementedError),
    (dict(nms_type="soft_nms_linear"), NotImplementedError),
    (dict(nms_type="bogus"), ValueError),
    (dict(exact_select="threshold"), ValueError),
    (dict(approx_topk=True), ValueError),
])
def test_multiclass_nms_unsupported_modes_raise(kw, err):
    boxes, scores = _candidates(14, n=8, c=3)
    with pytest.raises(err):
        multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                       score_thr=0.05, **kw)


def test_wrappers_check_inputs():
    b = torch.zeros(1, 5, 4)
    with pytest.raises(ValueError):
        nms_cuda.nms_mask(b.double(), 0.5)
    with pytest.raises(ValueError):
        nms_cuda.nms_mask(torch.zeros(1, 5, 3), 0.5)
    with pytest.raises(ValueError):
        nms_cuda.nms_reduce(nms_cuda.nms_mask(b, 0.5), torch.ones(1, 6, dtype=torch.bool))
    with pytest.raises(ValueError):
        nms_cuda.nms_reduce(nms_cuda.nms_mask(b, 0.5), torch.ones(1, 5))
    before = dict(nms_cuda.launches)
    nms_cuda.greedy_keep(b, torch.ones(1, 5, dtype=torch.bool), 0.5)
    assert nms_cuda.launches == before  # CPU tensors take the plain path

