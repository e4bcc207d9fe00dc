"""The bf16 detector of tests/test_torch_dtype.py against ioudet's on the CPU:
the whole detector's logits and the eval tail on the same bf16 head outputs
(tolerances as stated there).  Kept apart from the module-level tests so that
the two halves run on two test workers.  ``ioudet``'s bf16 forward and
tails run jitted, each compiled once for the module (``compiled``): an
eager forward compiles every primitive anew.  One intra-op thread for
torch, so that the test workers beside this one are not slowed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dtype import META, TEST_CFG, as_np, images, pair  # noqa: F401
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def compiled(pair):
    """ioudet's bf16 head outputs ``heads(x)``, and ``tail(outs,
    rescore_before_topk)``: its ``decode_candidates`` and ``get_bboxes`` of
    them, each compiled once."""
    _, _, params, _, det_bf16 = pair
    heads = jax.jit(lambda x: det_bf16.apply({"params": params}, x))
    meta = [jnp.asarray(m) for m in META]
    tails = {}

    def tail(outs, before):
        if before not in tails:
            cfg = dict(TEST_CFG, rescore_before_topk=before)

            def run(o):
                boxes_scores = det_bf16.apply(
                    {"params": params}, *o, meta[0], cfg,
                    method=lambda m, *a: m.bbox_head.decode_candidates(*a))
                return boxes_scores, det_bf16.apply(
                    {"params": params}, *o, *meta, cfg, rescale=True,
                    method=lambda m, *a, **k: m.bbox_head.get_bboxes(*a, **k))

            tails[before] = jax.jit(run)
        return tails[before](outs)

    return heads, tail


def test_detector_bf16_logit_drift(pair, compiled):
    model, twin, params, det, det_bf16 = pair
    x = images(seed=1)
    with torch.no_grad():
        f32 = model(torch.from_numpy(x))
        got = twin(torch.from_numpy(x))
    want = compiled[0](jnp.asarray(x))
    worst = [0.0, 0.0]
    for bg, bw, bf in zip(got, want, f32):
        for g, w, f in zip(bg, bw, bf):
            assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
            worst[0] = max(worst[0], float(np.abs(as_np(g) - as_np(w)).max()))
            worst[1] = max(worst[1], float(np.abs(as_np(g) - as_np(f)).max()))
    assert worst[0] <= 0.02, f"against ioudet's bf16 logits: {worst[0]}"
    assert 0.0 < worst[1] <= 0.03, f"against f32: {worst[1]}"


@pytest.mark.parametrize("rescore_before_topk", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_eval_tail_on_the_same_bf16_head_outputs(pair, compiled, seed, rescore_before_topk):
    """The tail alone: ioudet's bf16 head outputs go through both tails.  bf16
    scores tie often, so the selection rests on the stable sort and on the
    scores being bit-equal; labels are exact."""
    model, twin, params, _, det_bf16 = pair
    heads, tail = compiled
    cfg = dict(TEST_CFG, rescore_before_topk=rescore_before_topk)
    outs = heads(jnp.asarray(images(seed)))
    (jb, js), (jd, jl) = tail(outs, rescore_before_topk)
    touts = [[torch.from_numpy(np.array(as_np(o))).bfloat16() for o in branch]
             for branch in outs]
    with torch.no_grad():
        boxes, scores = twin.bbox_head.decode_candidates(
            *touts, torch.from_numpy(META[0]), cfg)
        dets, labels = twin.bbox_head.get_bboxes(
            *touts, *(torch.from_numpy(m) for m in META), cfg, rescale=True)
    assert scores.dtype == torch.bfloat16 and js.dtype == jnp.bfloat16
    np.testing.assert_array_equal(as_np(scores), as_np(js))
    top = as_np(scores).max(-1)
    assert (np.diff(np.sort(top.ravel())) == 0).mean() > 0.5   # ties are the rule
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    assert int((labels >= 0).sum()) == labels.numel()
    np.testing.assert_allclose(dets.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-4)
