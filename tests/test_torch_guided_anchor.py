"""Port parity of guided anchoring's parts on the CPU: ``masked_conv2d``,
``ApproxMaxIoUAssigner.assign_approx``, the squares, approxs and predicted
anchors, the loc targets (against ``ioudet`` and against the hand-derived
values of tests/test_guided_anchor_golden.py), the shape targets, and the
three heads (``GuidedAnchorHead``, ``GARetinaHead`` with two tower convs,
``GARPNHead``), 16 wide on five levels of seeded features, each built from
``ioudet``'s parameter tree filled with seeded values and bridged by
``state_dict_from_flax``.  One jitted ``ioudet`` program serves the two
tower heads: their outputs, ``decode_candidates`` and ``get_bboxes`` on
them and on planted outputs whose masked cells tie, the four losses of
planted gts and each loss's gradient w.r.t. the head outputs, and the
summed loss's gradient w.r.t. every parameter.

The loc mask ``sigmoid(loc) > loc_filter_thr`` sits on a knife-edge at
``ioudet``'s init (``conv_loc``'s bias at the 0.01 prior, its weights
normal(0.01)): the tests count the cells whose loc logit lies within the
forwards' tolerance (1e-5) of the threshold's logit, and hold the masks
equal everywhere else; the served twins draw ``conv_loc`` wide (std 1), so
that no cell is near the edge and the decode's kept indices are compared
exactly.  ``conv_shape`` is drawn at std 0.1 (|dw|, |dh| about 1: anchors of
a sensible size).

Tolerances: forwards rtol 1e-5 / atol 1e-5; losses rtol 1e-5; gradients
1e-4 of each tensor's largest |value|; kept indices and labels exact;
scores rtol 1e-5; boxes atol 1e-4.  Everything is f32 (``torch.float32``
throughout, TF32 is a card setting)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.core.bbox.assigners import ApproxMaxIoUAssigner as JaxApproxAssigner
from ioudet.models.heads import guided_anchor_head as jga
from ioudet.ops.masked_conv import masked_conv2d as jax_masked_conv2d
from ioudet_torch.apis.checkpoint import state_dict_from_flax
from ioudet_torch.core.bbox import ApproxMaxIoUAssigner
from ioudet_torch.models.heads import guided_anchor_head as tga
from ioudet_torch.ops.masked_conv import masked_conv2d
from tests.torch_twins import one_thread, param_shapes, random_params  # one_thread: autouse

WIDTH = 16
RETINA = dict(num_classes=4, in_channels=WIDTH, feat_channels=WIDTH, octave_base_scale=8,
              scales_per_octave=3, anchor_ratios=(0.5, 1.0, 2.0),
              anchor_strides=(8, 16, 32, 64, 128))
RPN = dict(num_classes=2, in_channels=WIDTH, feat_channels=WIDTH, octave_base_scale=8,
           scales_per_octave=3, anchor_ratios=(0.5, 1.0, 2.0), anchor_strides=(4, 8, 16, 32, 64),
           anchoring_stds=(0.07, 0.07, 0.14, 0.14), target_stds=(0.07, 0.07, 0.11, 0.11),
           loss_cls=dict(type="CrossEntropyLoss", use_sigmoid=True, loss_weight=1.0),
           loss_bbox=dict(type="SmoothL1Loss", beta=1.0, loss_weight=1.0))
HEADS = {"GARetinaHead": dict(RETINA, stacked_convs=2), "GARPNHead": RPN}
SIZES = {"GARetinaHead": [(12, 16), (6, 8), (3, 4), (2, 2), (1, 1)],
         "GARPNHead": [(24, 32), (12, 16), (6, 8), (3, 4), (2, 2)]}
TRAIN_CFG = {"GARetinaHead": dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                                                neg_iou_thr=0.4, min_pos_iou=0,
                                                ignore_iof_thr=-1), allowed_border=-1),
             "GARPNHead": dict(assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                                             neg_iou_thr=0.3, min_pos_iou=0.3),
                               ga_assigner=dict(type="ApproxMaxIoUAssigner", pos_iou_thr=0.7,
                                                neg_iou_thr=0.3, min_pos_iou=0.3),
                               allowed_border=0)}
TEST_CFG = dict(nms_pre=40, score_thr=0.05, nms=dict(iou_thr=0.5), max_per_img=20)
SHAPES = np.array([[96, 128], [80, 112]], np.int32)
FACTORS = np.array([1.0, 0.625], np.float32)
EDGE = float(np.log(0.01 / 0.99))   # the loc logit of loc_filter_thr
G = 6


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, tol, what):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * scale, err_msg=what)


def features(kind: str, seed: int = 1) -> list:
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, h, w, WIDTH)).astype(np.float32) for h, w in SIZES[kind]]


def gts() -> tuple:
    """Two images' gts in G slots: sizes of 20-90 px (levels 0-2 of
    GA-RetinaNet, 0-3 of GA-RPN), one on the boundary of two levels,
    padded slots over valid boxes."""
    b = np.zeros((2, G, 4), np.float32)
    b[0, :5] = [[4, 6, 40, 38], [50, 20, 110, 90], [8, 8, 100, 90], [60, 40, 90, 70],
                [20, 50, 83, 81]]
    b[1, :4] = [[20, 20, 52, 52], [8, 30, 100, 78], [70, 5, 106, 41], [12, 12, 28, 28]]
    b[1, 4:] = [[20, 20, 52, 52], [8, 30, 100, 78]]
    valid = np.zeros((2, G), bool)
    valid[0, :5] = True
    valid[1, :4] = True
    labels = np.array([[1, 2, 3, 2, 1, 0], [3, 1, 2, 3, 1, 2]], np.int32)
    return b, labels, valid


def planted_outputs(kind: str, seed: int = 4) -> tuple:
    """Head outputs whose class logits take three values and whose loc mask
    keeps 25 cells of level 0 and about a third of the others: level 0's
    top-40 cut runs through cells of equal score and through masked cells,
    which tie at 0."""
    rng = np.random.default_rng(seed)
    C = HEADS[kind]["num_classes"] - 1
    sizes = SIZES[kind]
    cls = [rng.choice([-1.0, 0.5, 2.0], (2, h, w, C)).astype(np.float32) for h, w in sizes]
    reg = [rng.uniform(-1, 1, (2, h, w, 4)).astype(np.float32) for h, w in sizes]
    shape = [rng.uniform(-0.5, 0.5, (2, h, w, 2)).astype(np.float32) for h, w in sizes]
    loc = [np.where(rng.uniform(0, 1, (2, h, w, 1)) < 0.35, 1.0, -6.0).astype(np.float32)
           for h, w in sizes]
    h, w = sizes[0]
    loc[0][:] = -6.0
    for i in range(2):
        kept = rng.choice(h * w, 25, replace=False)
        loc[0][i].reshape(-1)[kept] = 1.0
    return cls, reg, shape, loc


def jax_head(kind: str):
    return getattr(jga, kind)(**HEADS[kind])


def head_params(kind: str, loc_std: float) -> dict:
    """``ioudet``'s head tree with seeded values; ``conv_shape`` at std 0.1
    and ``conv_loc`` at std ``loc_std`` around the 0.01 prior."""
    params = random_params(param_shapes(jax_head(kind), [jnp.asarray(f) for f in
                                                         features(kind)]), 0)
    rng = np.random.default_rng(7)
    shape_k = params["conv_shape"]["kernel"]
    params["conv_shape"]["kernel"] = rng.normal(0, 0.1, shape_k.shape).astype(np.float32)
    loc_k = params["conv_loc"]["kernel"]
    params["conv_loc"]["kernel"] = rng.normal(0, loc_std, loc_k.shape).astype(np.float32)
    params["conv_loc"]["bias"] = np.full((1,), EDGE, np.float32)
    return params


def port_head(kind: str, params: dict):
    head = getattr(tga, kind)(**HEADS[kind])
    sd = state_dict_from_flax({"bbox_head": params}, {"bbox_head": kind})
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()}, strict=True)
    return head


@pytest.fixture(scope="module")
def twins():
    """{kind: (ioudet's results, the port's head at init-like conv_loc, the
    port's head with a wide conv_loc)}; ioudet's side in one program."""
    params = {kind: {edge: head_params(kind, 0.01 if edge else 1.0) for edge in (True, False)}
              for kind in HEADS}
    gb, gl, gv = (jnp.asarray(a) for a in gts())
    shapes, factors = jnp.asarray(SHAPES), jnp.asarray(FACTORS)

    def one(kind, p_edge, p_wide, feats, planted):
        head = jax_head(kind)
        cfg = TRAIN_CFG[kind]
        edge_outs = head.apply({"params": p_edge}, feats)
        outs, head_vjp = jax.vjp(lambda p: head.apply({"params": p}, feats), p_wide)
        served = (head.decode_candidates(*outs, shapes, TEST_CFG),
                  head.get_bboxes(*outs, shapes, factors, shapes, TEST_CFG, rescale=True),
                  head.decode_candidates(*planted, shapes, TEST_CFG),
                  head.get_bboxes(*planted, shapes, factors, shapes, TEST_CFG, rescale=True))
        # the four terms through one trace: each term's gradient w.r.t. the
        # outputs is a row of the vmapped VJP, the parameters' the VJP of
        # their sum through the head
        losses, loss_vjp = jax.vjp(lambda o: jnp.stack(list(head.loss(
            *o, gb, gl, gv, shapes, shapes, cfg).values())), outs)
        (out_grads,) = jax.vmap(loss_vjp)(jnp.eye(4, dtype=jnp.float32))
        (grads,) = head_vjp(jax.tree_util.tree_map(lambda g: g.sum(0), out_grads))
        return edge_outs, outs, served, losses, out_grads, grads

    def run(p, f, planted):
        return {kind: one(kind, p[kind][True], p[kind][False], f[kind], planted[kind])
                for kind in HEADS}

    feats = {kind: [jnp.asarray(x) for x in features(kind)] for kind in HEADS}
    planted = {kind: tuple([jnp.asarray(x) for x in lvls] for lvls in planted_outputs(kind))
               for kind in HEADS}
    ref = jax.device_get(jax.jit(run)(params, feats, planted))
    return {kind: (ref[kind], port_head(kind, params[kind][True]),
                   port_head(kind, params[kind][False]), params[kind][False]) for kind in HEADS}


CONV_CASES = [(1, "SAME", 3, True), (2, "SAME", 3, True), (1, 1, 3, False), (1, "SAME", 1, True),
              (2, 0, 3, True)]
IGNORE = (np.array([[16, 16, 100, 90], [0, 0, 0, 0]], np.float32), np.array([True, False]))


def conv_inputs(case) -> tuple:
    """(x, kernel, bias, mask) of a masked-conv case; the mask keeps about
    half of the output positions."""
    stride, padding, k, with_bias = case
    rng = np.random.default_rng(stride * 10 + k)
    x = rng.normal(0, 1, (2, 10, 12, 5)).astype(np.float32)
    kernel = rng.normal(0, 0.3, (k, k, 5, 7)).astype(np.float32)
    bias = rng.normal(0, 1, (7,)).astype(np.float32) if with_bias else None
    out = masked_conv2d(t(x), t(kernel), torch.ones(1, 1, 1), stride=stride, padding=padding)
    return x, kernel, bias, rng.uniform(0, 1, out.shape[:3]) < 0.5


def grids(kind: str) -> tuple:
    """The port's (squares (C, 4), approxs (C, 9, 4)) of a head's levels."""
    head = getattr(tga, kind)(**HEADS[kind])
    sizes = SIZES[kind]
    squares = torch.cat(head.level_squares(sizes, "cpu"))
    return squares, torch.cat(head.level_approxs(sizes, "cpu")).reshape(-1, 9, 4)


def assigner_kw(kind: str, with_ignore: bool = False) -> dict:
    ga = TRAIN_CFG[kind].get("ga_assigner", {})
    return dict(pos_iou_thr=ga.get("pos_iou_thr", 0.5), neg_iou_thr=ga.get("neg_iou_thr", 0.4),
                min_pos_iou=ga.get("min_pos_iou", 0.0),
                ignore_iof_thr=0.5 if with_ignore else -1.0)


@pytest.fixture(scope="module")
def refs():
    """ioudet's side of the tests below in one program: the masked convs,
    the approx assignments (with and without ignore regions, and the heads'
    own), the grids and predicted anchors, the loc targets and the base
    head's forward."""
    gb, gl, gv = gts()
    cases = [conv_inputs(c) for c in CONV_CASES]
    base = jga.GuidedAnchorHead(**RETINA)
    base_feats = [jnp.asarray(f) for f in features("GARetinaHead")]
    base_params = random_params(param_shapes(base, base_feats), 3)
    arrays = dict(cases=cases, grids={k: tuple(x.numpy() for x in grids(k)) for k in HEADS},
                  shape={k: planted_outputs(k)[2] for k in HEADS}, gb=gb, gl=gl, gv=gv,
                  ignore=IGNORE, base=(base_params, base_feats))

    def run(a):
        out = dict(conv=[jax_masked_conv2d(x, kern, mask, bias, c[0], c[1])
                         for (x, kern, bias, mask), c in zip(a["cases"], CONV_CASES)])
        squares, approxs = a["grids"]["GARetinaHead"]
        every = jnp.ones((squares.shape[0],), bool)
        out["assign"] = {ig: [JaxApproxAssigner(**assigner_kw("GARetinaHead", ig)).assign_approx(
            approxs, squares, a["gb"][i], a["gv"][i], every, a["gl"][i], *a["ignore"])
            for i in range(2)] for ig in (False, True)}
        for kind in HEADS:
            jhead, sizes = jax_head(kind), SIZES[kind]
            squares, approxs = a["grids"][kind]
            every = jnp.ones((squares.shape[0],), bool)
            out[kind] = dict(
                squares=[g.grid_anchors(fs, s) for g, fs, s in zip(
                    jhead.square_generators(), sizes, jhead.anchor_strides)],
                approxs=[g.grid_anchors(fs, s) for g, fs, s in zip(
                    jhead.approx_generators(), sizes, jhead.anchor_strides)],
                anchors=jhead.predicted_anchors(a["shape"][kind], sizes),
                loc=jhead._loc_targets(a["gb"], a["gv"], sizes),
                shape=[JaxApproxAssigner(**assigner_kw(kind)).assign_approx(
                    approxs, squares, a["gb"][i], a["gv"][i], every).gt_inds for i in range(2)])
        params, feats = a["base"]
        out["base"] = base.apply({"params": params}, feats)
        return out

    return jax.device_get(jax.jit(run)(arrays)), base_params


# ------------------------------------------------------------------ masked conv

@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_masked_conv2d_matches_ioudet(refs, case):
    stride, padding, _, _ = CONV_CASES[case]
    x, kernel, bias, mask = conv_inputs(CONV_CASES[case])
    want = refs[0]["conv"][case]
    got = masked_conv2d(t(x), t(kernel), t(mask), None if bias is None else t(bias), stride,
                        padding)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert (got.numpy()[~mask] == 0).all() and mask.any() and (~mask).any()
    got_f = masked_conv2d(t(x), t(kernel), t(mask.astype(np.float32)),
                          None if bias is None else t(bias), stride, padding)
    np.testing.assert_array_equal(got_f.numpy(), got.numpy())


# --------------------------------------------------------------- approx assigner

@pytest.mark.parametrize("with_ignore", [False, True])
def test_assign_approx_matches_ioudet(refs, with_ignore):
    squares, approxs = grids("GARetinaHead")
    gb, gl, gv = gts()
    assigner = ApproxMaxIoUAssigner(**assigner_kw("GARetinaHead", with_ignore))
    for i, want in enumerate(refs[0]["assign"][with_ignore]):
        got = assigner.assign_approx(approxs, squares, t(gb[i]), t(gv[i]),
                                     torch.ones(squares.shape[0], dtype=torch.bool), t(gl[i]),
                                     *(t(a) for a in IGNORE))
        np.testing.assert_array_equal(got.gt_inds.numpy(), want.gt_inds)
        np.testing.assert_array_equal(got.labels.numpy(), want.labels)
        np.testing.assert_allclose(got.max_overlaps.numpy(), want.max_overlaps, rtol=1e-6,
                                   atol=1e-7)
        assert (got.gt_inds > 0).sum() >= gv[i].sum()
    # the ignore region [16, 16, 100, 90] takes cells of the first image out
    assert (refs[0]["assign"][True][0].gt_inds != refs[0]["assign"][False][0].gt_inds).any()


def test_assign_approx_batched_equals_per_image():
    squares, approxs = grids("GARetinaHead")
    gb, gl, gv = (t(a) for a in gts())
    every = torch.ones(2, squares.shape[0], dtype=torch.bool)
    assigner = ApproxMaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4)
    batched = assigner.assign_approx(approxs, squares, gb, gv, every, gl)
    for i in range(2):
        one = assigner.assign_approx(approxs, squares, gb[i], gv[i], every[i], gl[i])
        assert torch.equal(batched.gt_inds[i], one.gt_inds)


# ----------------------------------------------------------------- anchors

@pytest.mark.parametrize("kind", list(HEADS))
def test_squares_approxs_and_predicted_anchors_match_ioudet(refs, kind):
    want = refs[0][kind]
    head = getattr(tga, kind)(**HEADS[kind])
    sizes = SIZES[kind]
    assert head.num_approx == jax_head(kind).num_approx == 9 and head.num_anchors == 1
    for lvl in range(5):
        np.testing.assert_array_equal(head.level_squares(sizes, "cpu")[lvl].numpy(),
                                      want["squares"][lvl])
        np.testing.assert_array_equal(head.level_approxs(sizes, "cpu")[lvl].numpy(),
                                      want["approxs"][lvl])
    # squares are centred on their cells, as every anchor: stride 8's first
    # square at octave 8 is 64 wide around (3.5, 3.5)
    sq = head.level_squares(sizes, "cpu")[1 if kind == "GARPNHead" else 0][0]
    np.testing.assert_array_equal(sq.numpy(), [-28, -28, 35, 35])
    got = head.predicted_anchors([t(x) for x in planted_outputs(kind)[2]])
    for g, w in zip(got, want["anchors"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-4)
    zero = head.predicted_anchors([torch.zeros(1, h, w, 2) for h, w in sizes])
    for z, sq in zip(zero, head.level_squares(sizes, "cpu")):
        np.testing.assert_allclose(z[0].numpy(), sq.numpy(), atol=1e-4)


# -------------------------------------------------------------- targets

@pytest.mark.parametrize("kind", list(HEADS))
def test_loc_targets_match_ioudet(refs, kind):
    want_t, want_w = refs[0][kind]["loc"]
    head = getattr(tga, kind)(**HEADS[kind])
    gb, _, gv = gts()
    got_t, got_w = head.loc_targets(t(gb), t(gv), SIZES[kind])
    for lvl in range(5):
        np.testing.assert_array_equal(got_t[lvl].numpy(), want_t[lvl])
        np.testing.assert_array_equal(got_w[lvl].numpy(), want_w[lvl])
    assert sum(int(x.sum()) for x in got_t) > 0 and sum(int((x == 0).sum()) for x in got_w) > 0
    # padded slots over valid boxes change nothing
    ref = head.loc_targets(t(gb[1:, :4]), t(gv[1:, :4]), SIZES[kind])
    for a, b in zip(ref[0] + ref[1], got_t + got_w):
        np.testing.assert_array_equal(a.numpy(), b[1:].numpy())


def golden_head():
    return tga.GuidedAnchorHead(num_classes=2, in_channels=8, feat_channels=8,
                                anchor_strides=(8, 16), anchor_ratios=(1.0,),
                                octave_base_scale=4, scales_per_octave=1, center_ratio=0.5,
                                ignore_ratio=1.0)


def test_loc_targets_hand_derived_values():
    """tests/test_guided_anchor_golden.py's cases: gt [0, 0, 31, 31] (scale
    32 = base: level 0) gives 4 positive cells and a 16-cell ignore square
    on level 0 and 4 ignored cells on level 1; a 64-wide gt goes to level 1
    and ignores all of level 0."""
    head = golden_head()
    sizes = [(8, 8), (4, 4)]
    tg, wt = head.loc_targets(t([[[0.0, 0.0, 31.0, 31.0]]]), torch.ones(1, 1, dtype=torch.bool),
                              sizes)
    exp_t0 = np.zeros((8, 8))
    exp_t0[1:3, 1:3] = 1
    exp_w0 = np.ones((8, 8))
    exp_w0[0:4, 0:4] = 0
    exp_w0[1:3, 1:3] = 1
    exp_w1 = np.ones((4, 4))
    exp_w1[0:2, 0:2] = 0
    np.testing.assert_array_equal(tg[0].numpy().reshape(8, 8), exp_t0)
    np.testing.assert_array_equal(wt[0].numpy().reshape(8, 8), exp_w0)
    np.testing.assert_array_equal(tg[1].numpy().reshape(4, 4), 0)
    np.testing.assert_array_equal(wt[1].numpy().reshape(4, 4), exp_w1)
    tg, wt = head.loc_targets(t([[[0.0, 0.0, 63.0, 63.0]]]), torch.ones(1, 1, dtype=torch.bool),
                              sizes)
    exp = np.zeros((4, 4))
    exp[1:3, 1:3] = 1
    assert tg[0].sum() == 0
    np.testing.assert_array_equal(tg[1].numpy().reshape(4, 4), exp)
    np.testing.assert_array_equal(wt[0].numpy(), 0)


def test_loss_shape_zero_when_gt_is_a_square():
    """The golden case: shape predictions 0 make the predicted anchors the
    squares; a gt equal to lvl-0 cell (2, 2)'s square [4, 4, 35, 35] makes
    only that cell positive (ga_assigner pos 0.65) and its bounded-IoU loss
    0; the other terms are finite.  The loc term on constant logits -2 is
    the hand-derived focal sum over the golden targets, by 4 positives."""
    head = golden_head()
    sizes = [(8, 8), (4, 4)]
    np.testing.assert_array_equal(head.level_squares(sizes, "cpu")[0].reshape(8, 8, 4)[2, 2],
                                  [4, 4, 35, 35])
    outs = ([torch.full((1, h, w, 1), -4.0) for h, w in sizes],
            [torch.zeros(1, h, w, 4) for h, w in sizes],
            [torch.zeros(1, h, w, 2) for h, w in sizes],
            [torch.full((1, h, w, 1), -2.0) for h, w in sizes])
    gt, gl, gv = t([[[4.0, 4.0, 35.0, 35.0]]]), torch.ones(1, 1, dtype=torch.int32), \
        torch.ones(1, 1, dtype=torch.bool)
    shapes = t(np.array([[64, 64]], np.int32))
    cfg = dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
               ga_assigner=dict(pos_iou_thr=0.65, neg_iou_thr=0.4, min_pos_iou=0.0),
               allowed_border=-1)
    got = head.loss(*outs, gt, gl, gv, shapes, shapes, cfg)
    pos, _ = head.shape_targets(sizes, gt, gv, cfg)
    assert int(pos.sum()) == 1 and bool(pos[0, 2 * 8 + 2])
    assert float(got["loss_shape"]) == pytest.approx(0.0, abs=1e-6)
    assert all(np.isfinite(float(v)) for v in got.values())
    tg, wt = head.loc_targets(gt, gv, sizes)
    tg, wt = torch.cat(tg, 1).numpy(), torch.cat(wt, 1).numpy()
    p = 1.0 / (1.0 + np.exp(2.0))
    f_pos, f_neg = 0.25 * (1 - p) ** 2 * -np.log(p), 0.75 * p ** 2 * -np.log(1 - p)
    want = ((tg * f_pos + (1 - tg) * f_neg) * wt).sum() / max(tg.sum(), 1.0)
    np.testing.assert_allclose(float(got["loss_loc"]), want, rtol=1e-5)


@pytest.mark.parametrize("kind", list(HEADS))
def test_shape_targets_match_ioudet(refs, kind):
    """The approx assignment of every cell (the head's ga_assigner
    thresholds) against ioudet's assigner: positives and their gts exact."""
    head = getattr(tga, kind)(**HEADS[kind])
    gb, _, gv = gts()
    pos, matched = head.shape_targets(SIZES[kind], t(gb), t(gv), TRAIN_CFG[kind])
    for i, gt_inds in enumerate(refs[0][kind]["shape"]):
        want_pos = gt_inds > 0
        np.testing.assert_array_equal(pos[i].numpy(), want_pos)
        idx = np.clip(gt_inds - 1, 0, G - 1)
        np.testing.assert_array_equal(matched[i].numpy()[want_pos], gb[i][idx][want_pos])
        assert want_pos.sum() >= gv[i].sum()


# ------------------------------------------------------------------ heads

def test_base_head_forward_matches_ioudet(refs):
    """``GuidedAnchorHead`` itself: the branches on the features, one
    adaption for cls and reg."""
    want, params = refs[0]["base"], refs[1]
    head = tga.GuidedAnchorHead(**RETINA)
    sd = state_dict_from_flax({"bbox_head": params}, {"bbox_head": "GuidedAnchorHead"})
    head.load_state_dict({k[len("bbox_head."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = head(nchw("GARetinaHead"))
    for i, (g_l, w_l) in enumerate(zip(got, want)):
        for g, w in zip(g_l, w_l):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=f"output {i}")


def nchw(kind: str) -> list:
    return [t(f).permute(0, 3, 1, 2) for f in features(kind)]


@pytest.mark.parametrize("kind", list(HEADS))
def test_head_outputs_match_ioudet(twins, kind):
    (edge_outs, outs, *_), edge_head, head, _ = twins[kind]
    with torch.no_grad():
        for ours, ref in ((head(nchw(kind)), outs), (edge_head(nchw(kind)), edge_outs)):
            for i, (o_l, r_l) in enumerate(zip(ours, ref)):
                for lvl, (o, r) in enumerate(zip(o_l, r_l)):
                    assert tuple(o.shape) == r.shape
                    np.testing.assert_allclose(o.numpy(), r, rtol=1e-5, atol=1e-5,
                                               err_msg=f"{kind} output {i} level {lvl}")
    C = HEADS[kind]["num_classes"] - 1
    assert [o[0].shape[-1] for o in ours] == [C, 4, 2, 1]


@pytest.mark.parametrize("kind", list(HEADS))
def test_loc_mask_on_the_knife_edge(twins, kind):
    """At ioudet's init conv_loc sits on the threshold: the cells within
    the forwards' tolerance of its logit are counted, every other cell's
    mask equals ioudet's; with conv_loc drawn wide none is near it."""
    (edge_outs, outs, *_), edge_head, head, _ = twins[kind]
    counts = {}
    with torch.no_grad():
        for name, h, ref in (("init", edge_head, edge_outs), ("wide", head, outs)):
            loc = torch.cat([x.reshape(-1) for x in h(nchw(kind))[3]])
            ref_loc = np.concatenate([x.reshape(-1) for x in ref[3]])
            thr = h.loc_filter_thr
            near = np.abs(ref_loc - EDGE) <= 1e-5
            got = (torch.sigmoid(loc) > thr).numpy()
            want = np.asarray(jax.nn.sigmoid(jnp.asarray(ref_loc)) > thr)
            np.testing.assert_array_equal(got[~near], want[~near], err_msg=f"{kind} {name}")
            counts[name] = (int(near.sum()), near.size, int(want.sum()))
    assert counts["wide"][0] == 0, counts
    # at init every cell's logit is within 0.2 of the edge, both sides taken
    assert 0 < counts["init"][2] < counts["init"][1], counts


@pytest.mark.parametrize("kind", list(HEADS))
@pytest.mark.parametrize("planted", [False, True])
def test_decode_matches_ioudet(twins, kind, planted):
    """``decode_candidates`` on ioudet's own head outputs (planted: three
    logit values and a loc mask keeping a third of the cells, so that the
    top-k cut runs through equal scores and through masked cells tied at
    0): scores exact, boxes atol 1e-4; ``get_bboxes``'s labels exact."""
    (_, outs, served, *_), _, head, _ = twins[kind]
    cand, dets = (served[2], served[3]) if planted else (served[0], served[1])
    lvls = planted_outputs(kind) if planted else outs
    with torch.no_grad():
        b, s = head.decode_candidates(*([t(x) for x in lv] for lv in lvls), t(SHAPES), TEST_CFG)
        d, lab = head.get_bboxes(*([t(x) for x in lv] for lv in lvls), t(SHAPES), t(FACTORS),
                                 t(SHAPES), TEST_CFG, rescale=True)
    np.testing.assert_allclose(s.numpy(), cand[1], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(b.numpy(), cand[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(lab.numpy(), dets[1])
    np.testing.assert_allclose(d.numpy(), dets[0], rtol=1e-5, atol=1e-4)
    assert (dets[1] >= 0).sum() > 4
    if planted:
        p = torch.sigmoid(t(lvls[0][0])).amax(-1) * (t(lvls[3][0])[..., 0] > 0)
        top = p.reshape(2, -1).sort(dim=1, descending=True).values
        assert (top[:, 39] == 0).all() and ((top == top[:, :1]).sum(1) > 3).all()
        # the masked picks are the lowest-index masked cells
        assert (s[:, :40].amax(-1) == 0).sum() > 0


@pytest.mark.parametrize("kind", list(HEADS))
def test_losses_and_gradients_match_ioudet(twins, kind):
    (_, outs, _, losses, out_grads, grads), _, head, _ = twins[kind]
    gb, gl, gv = (t(a) for a in gts())
    leaves = [[t(x).requires_grad_() for x in lv] for lv in outs]
    got = head.loss(*leaves, gb, gl, gv, t(SHAPES), t(SHAPES), TRAIN_CFG[kind])
    assert list(got) == ["loss_cls", "loss_bbox", "loss_shape", "loss_loc"]
    for j, (name, value) in enumerate(got.items()):
        assert float(losses[j]) > 0, name
        np.testing.assert_allclose(float(value.detach()), float(losses[j]), rtol=1e-5,
                                   err_msg=f"{kind} {name}")
        for lv in leaves:
            for x in lv:
                x.grad = None
        value.backward(retain_graph=True)
        for i, (lv, ref_lv) in enumerate(zip(leaves, out_grads)):
            ref = np.concatenate([r[j].reshape(-1) for r in ref_lv])
            if not ref.any():
                assert all(x.grad is None or not x.grad.any() for x in lv), (name, i)
                continue
            mine = np.concatenate([(x.grad if x.grad is not None else torch.zeros_like(x))
                                   .reshape(-1).numpy() for x in lv])
            assert_close_scaled(mine, ref, 1e-4, f"{kind} d{name}/d(output {i})")
    # each term reaches its own output: cls, reg, shape, loc
    assert [[i for i, r in enumerate(out_grads) if any(x[j].any() for x in r)]
            for j in range(4)] == [[0], [1], [2], [3]]


@pytest.mark.parametrize("kind", list(HEADS))
def test_parameter_gradients_match_ioudet(twins, kind):
    """The summed loss's gradient w.r.t. every parameter, through the
    towers, the one adaption used twice (GARetinaHead) and the trunk."""
    (*_, grads), _, head, _ = twins[kind]
    head.zero_grad()
    gb, gl, gv = (t(a) for a in gts())
    sum(head.loss(*head(nchw(kind)), gb, gl, gv, t(SHAPES), t(SHAPES),
                  TRAIN_CFG[kind]).values()).backward()
    sd = state_dict_from_flax({"bbox_head": grads}, {"bbox_head": kind})
    ref = {k[len("bbox_head."):]: v for k, v in sd.items()}
    assert sorted(ref) == sorted(n for n, _ in head.named_parameters())
    for name, p in head.named_parameters():
        assert float(ref[name].abs().max()) > 0, name
        assert_close_scaled(p.grad.numpy(), ref[name].numpy(), 1e-4, f"{kind} {name}")


def test_the_bridge_takes_ga_branches_only_when_named(twins):
    *_, params = twins["GARetinaHead"]
    with pytest.raises(KeyError, match="unknown head param"):
        state_dict_from_flax({"bbox_head": params})
    names = set(state_dict_from_flax({"bbox_head": params}, {"bbox_head": "GARetinaHead"}))
    assert {"bbox_head.conv_loc.weight", "bbox_head.conv_shape.bias",
            "bbox_head.feature_adaption.conv_offset.weight",
            "bbox_head.feature_adaption.conv_adaption.weight", "bbox_head.conv_cls.bias",
            "bbox_head.cls_convs.1.conv.weight"} <= names
