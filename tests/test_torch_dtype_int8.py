"""The w8a8 int8 detector of tests/test_torch_dtype.py against ioudet's on
the CPU: scales calibrated on either side and carried across the bridge,
static and dynamic int8 head outputs, bf16 + static int8, and ``predict``
inside ``quantize_calls`` (tolerances as stated there).  Kept apart from the
module-level tests so that they run on another test worker.  ``ioudet``'s
quantized forwards run jitted (``heads_jit``): traced inside
``quantize_calls``, so the interceptor quantizes the compiled program, one
compile each, where an eager forward compiles every primitive anew; the
calibration passes stay eager, as ``calibrate`` requires.  One intra-op
thread for torch, so that the test workers beside this one are not
slowed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ioudet.ops import quant as jquant
from ioudet_torch.apis import checkpoint as ckpt
from ioudet_torch.apis.inference import DetectorHandle, predict
from ioudet_torch.ops import quant
from tests.test_torch_dtype import MODEL, META, TEST_CFG, as_np, images, pair  # noqa: F401
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


def heads_flax(det, params, x):
    return det.apply({"params": params}, jnp.asarray(x))


def heads_jit(det, params, x):
    """``heads_flax`` compiled where it is called (inside a
    ``quantize_calls`` block, the quantized program)."""
    return jax.jit(lambda p, img: det.apply({"params": p}, img))(params, jnp.asarray(x))


def test_scale_keys_cross_the_bridge(pair):
    model, _, params, det, _ = pair
    x = images(seed=2, batch=1)
    want = jquant.calibrate(lambda b: heads_flax(det, params, b), [x])
    with torch.no_grad():
        got = quant.calibrate(model, model, [torch.from_numpy(x)])
    assert len(got) == 30 and not any("retina_" in k for k in got)
    crossed = ckpt.act_scales_to_flax(got)
    assert sorted(crossed) == sorted(want)
    for k in want:
        assert crossed[k] == pytest.approx(want[k], rel=1e-5), k
    back = ckpt.act_scales_from_flax(want)
    assert sorted(back) == sorted(got)
    assert ckpt.act_scales_from_flax(crossed) == got


def test_detector_int8_static_matches_ioudet(pair):
    """f32 compute, static scales calibrated by ioudet and carried across."""
    model, _, params, det, _ = pair
    x = images(seed=3, batch=1)
    jscales = jquant.calibrate(lambda b: heads_flax(det, params, b), [images(seed=4, batch=1)])
    with jquant.quantize_calls(act_scale=jscales):
        want = heads_jit(det, params, x)
    with torch.no_grad():
        f32 = model(torch.from_numpy(x))
        with quant.quantize_calls(model, act_scale=ckpt.act_scales_from_flax(jscales)):
            got = model(torch.from_numpy(x))
    worst = max(float(np.abs(as_np(g) - as_np(w)).max())
                for bg, bw in zip(got, want) for g, w in zip(bg, bw))
    drift = max(float((g - f).abs().max()) for bg, bf in zip(got, f32) for g, f in zip(bg, bf))
    assert worst <= 5e-3, worst
    assert drift > 0.0   # the quantized path was taken


def test_detector_int8_dynamic_matches_ioudet(pair):
    model, _, params, det, _ = pair
    x = images(seed=5, batch=1)
    with jquant.quantize_calls():
        want = heads_jit(det, params, x)
    with torch.no_grad():
        f32 = model(torch.from_numpy(x))
        with quant.quantize_calls(model):
            got = model(torch.from_numpy(x))
    worst = max(float(np.abs(as_np(g) - as_np(w)).max())
                for bg, bw in zip(got, want) for g, w in zip(bg, bw))
    drift = max(float((g - f).abs().max()) for bg, bf in zip(got, f32) for g, f in zip(bg, bf))
    assert worst <= 0.05, worst
    assert 0.0 < drift < 0.35, drift   # test_quant.py's bound on the same detector


def test_detector_bf16_int8_drift(pair):
    """The serving configuration: bf16 compute with static int8 convs."""
    model, twin, params, _, det_bf16 = pair
    x = images(seed=6, batch=1)
    with torch.no_grad():
        scales = quant.calibrate(twin, twin, [torch.from_numpy(images(seed=7, batch=1))])
        f32 = model(torch.from_numpy(x))
        with quant.quantize_calls(twin, act_scale=scales):
            got = twin(torch.from_numpy(x))
    with jquant.quantize_calls(act_scale=ckpt.act_scales_to_flax(scales)):
        want = heads_jit(det_bf16, params, x)
    for bg, bw, bf in zip(got, want, f32):
        for g, w, f in zip(bg, bw, bf):
            assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
            assert float(np.abs(as_np(g) - as_np(f)).max()) > 0.0
            assert float(np.abs(as_np(g) - as_np(w)).max()) < 0.05


def test_predict_inside_quantize_calls(pair):
    """predict under quantize_calls equals predict with the forwards swapped
    by hand, and the state_dict is bit-unchanged afterwards, also after an
    exception inside the block."""
    twin = pair[1]
    handle = DetectorHandle(twin, dict(model=MODEL, test_cfg=TEST_CFG), torch.device("cpu"))
    args = (torch.from_numpy(images(seed=8)), *(torch.from_numpy(m) for m in META))
    before = {k: v.clone() for k, v in twin.state_dict().items()}
    scales = quant.calibrate(twin, lambda b: predict(handle, *b), [args])
    plain = predict(handle, *args)
    with quant.quantize_calls(twin, act_scale=scales):
        dets, labels = predict(handle, *args)

    convs = dict(quant.eligible_convs(twin))
    assert len(convs) == 30 and set(convs) == set(scales)
    try:
        for path, mod in convs.items():
            mod.forward = (lambda m, s: lambda x: quant.quant_conv_call(
                m, x, torch.tensor(s, dtype=torch.float32)))(mod, scales[path])
        by_hand = predict(handle, *args)
    finally:
        for mod in convs.values():
            del mod.forward
    assert torch.equal(dets, by_hand[0]) and torch.equal(labels, by_hand[1])
    assert tuple(dets.shape) == (2, 10, 5) and bool(torch.isfinite(dets).all())
    assert not torch.equal(dets, plain[0])   # the quantized path was taken

    with pytest.raises(ZeroDivisionError):
        with quant.quantize_calls(twin, act_scale=scales):
            predict(handle, *args)
            1 / 0
    after = twin.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    again = predict(handle, *args)
    assert torch.equal(again[0], plain[0]) and torch.equal(again[1], plain[1])
