"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA NMS kernels from ioudet_torch/csrc with nvcc;
  2. each kernel against its plain torch version on the card, bit for bit,
     on adversarial cases (N in 1, 63, 64, 65, 1000, 2000 at batch 16);
  3. the flagship IoU-aware RetinaNet R-50-FPN (configs/
     iou_aware_retinanet_r50_fpn_1x.py with class_topk=4, the model of
     __graft_entry__.FLAGSHIP/TEST_CFG) at full width with seeded random
     weights: ``predict`` on a batch of 832x1344 canvases with host syncs
     made errors, then three ``inference_detector`` requests, with launch
     counts, output checks, a plain-NMS replay and a GPU-vs-CPU forward on a
     small canvas;
  4. timings: ``predict`` at batch 1 and 16, each kernel against its plain
     version at N=2000, batch 16.
The last two lines are the card's name and power limit, then
``{"ok": true, "device": {...}}``; the line before them lists the kernels.
"""

from __future__ import annotations

import json
import os
import runpy
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "iou_aware_retinanet_r50_fpn_1x.py")
NMS_SIZES = (1, 63, 64, 65, 1000, 2000)
BATCH = 16


# ------------------------------------------------------------ NMS test cases

def nms_cases(n: int, batch: int, seed: int = 0):
    """Adversarial inputs for the greedy NMS kernels: a list of
    (name, boxes (batch, n, 4) f32 in score order, valid (batch, n) bool),
    built with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    j = np.arange(n)

    def rand_boxes(lo=0.0, hi=200.0):
        xy = rng.uniform(lo, hi, (batch, n, 2))
        wh = rng.uniform(4.0, 60.0, (batch, n, 2))
        return np.concatenate([xy, xy + wh], -1)

    # chains of nested squares: IoU(step, step+1) > 0.5 > IoU(step, step+2),
    # so greedy keeps every other box and the outcome depends on the order
    side = 10.0 * 1.3 ** (j % 8)
    x0 = 1000.0 * (j // 8)
    chain = np.stack([x0, x0, x0 + side, x0 + side], -1)
    chain = np.broadcast_to(chain, (batch, n, 4)) + \
        rng.integers(0, 50, (batch, 1, 1)) * 1.0
    # groups of 4 identical boxes: each group keeps its first valid member
    dup = np.repeat(rand_boxes()[:, ::4], 4, axis=1)[:, :n]
    # class-offset candidates: the offsets multiclass_nms adds reach ~1e5,
    # where the f32 spacing is ~0.008; four classes keep them dense
    labels = rng.integers(0, 4, (batch, n, 1))
    offset = rand_boxes() + 1e5 + labels * 1401.0
    # pairs whose IoU is exactly 0.5 (10x10 inside 10x20, +1 areas), also at
    # a 1e5 offset: IoU > thr must not fire
    base = np.array([0.0, 0.0, 9.0, 9.0])
    tall = np.array([0.0, 0.0, 9.0, 19.0])
    pair = np.where((j % 2 == 0)[:, None], base, tall) + (j // 2 * 40.0)[:, None]
    thresh = np.broadcast_to(pair, (batch, n, 4)) + \
        np.where(rng.uniform(size=(batch, 1, 1)) < 0.5, 0.0, 1e5)

    all_valid = np.ones((batch, n), bool)
    some_valid = rng.uniform(size=(batch, n)) < 0.6
    cases = [("random", rand_boxes(), rng.uniform(size=(batch, n)) < 0.9),
             ("chains", chain, all_valid), ("chains_invalid", chain, some_valid),
             ("duplicates", dup, some_valid), ("class_offset", offset, all_valid),
             ("iou_at_threshold", thresh, all_valid)]
    return [(name, np.ascontiguousarray(b, dtype=np.float32), v)
            for name, b, v in cases]


# ----------------------------------------------------------------- helpers

def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median wall time of fn() ending in a device sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    print(f"ok: {what}", flush=True)


def set_tf32(on: bool) -> None:
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


# ------------------------------------------------------------------ phases

def phase_kernels(K) -> dict:
    """Each kernel against its plain version on the card; returns the
    largest difference of each (0 means bit-equal)."""
    err = {"nms_mask_kernel": 0.0, "nms_reduce_kernel": 0.0}
    for n in NMS_SIZES:
        for name, boxes, valid in nms_cases(n, BATCH, seed=n):
            b = torch.from_numpy(boxes).cuda()
            v = torch.from_numpy(valid).cuda()
            words = K.nms_mask(b, 0.5)
            torch.cuda.synchronize()
            keep = K.nms_reduce(words, v)
            torch.cuda.synchronize()
            plain_words = K.nms_mask_plain(b, 0.5)
            plain_keep = K.nms_reduce_plain(plain_words, v)
            torch.cuda.synchronize()
            # the largest |difference| of a mask bit and of a keep flag
            err["nms_mask_kernel"] = max(err["nms_mask_kernel"],
                                         float((words != plain_words).any()))
            err["nms_reduce_kernel"] = max(err["nms_reduce_kernel"],
                                           float((keep != plain_keep).any()))
            check(torch.equal(words, plain_words) and torch.equal(keep, plain_keep),
                  f"N={n} {name}: mask words and keep bit-equal to plain "
                  f"({int(keep.sum())} kept of {int(v.sum())} valid)")
    # every selection of the slice relies on stable descending sort keeping
    # ties in index order on the card, as lax.top_k does
    x = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0] * 4000, device="cuda")
    idx = torch.sort(x, descending=True, stable=True)[1][:12000]
    check(bool((idx[1:] > idx[:-1]).all()), "stable sort breaks ties by index")
    return err


def flagship_cfg() -> dict:
    cfg = runpy.run_path(CONFIG)
    test_cfg = dict(cfg["test_cfg"], class_topk=4)  # __graft_entry__.TEST_CFG
    return dict(model=cfg["model"], test_cfg=test_cfg, data=cfg["data"])


def canvases(batch: int, rng) -> tuple:
    from ioudet_torch.ops.preprocess import preprocess_batch
    imgs = torch.from_numpy(rng.integers(0, 256, (batch, 800, 1333, 3),
                                         dtype=np.uint8)).cuda()
    shapes = torch.tensor([[800, 1333]] * batch, dtype=torch.int32, device="cuda")
    img, img_shapes, factors = preprocess_batch(imgs, shapes, flip_channels=True)
    pad = torch.tensor([[832, 1344]] * batch, dtype=torch.int32, device="cuda")
    return img, img_shapes, factors, pad


def phase_slice(K, handle, inputs) -> dict:
    """Returns the kernels' launch counts of the main path's run."""
    from ioudet_torch.apis.inference import inference_detector, predict

    nc = handle.model.bbox_head.cls_out_channels
    predict(handle, *inputs)  # warm-up: anchors reach the device here
    torch.cuda.synchronize()
    K.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        dets, labels = predict(handle, *inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rng = np.random.default_rng(1)
    requests = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
                for h, w in ((480, 640), (800, 1333), (1333, 800))]
    results = [inference_detector(handle, im) for im in requests]
    torch.cuda.synchronize()
    counts = dict(K.launches)
    check(all(c >= 1 for c in counts.values()),
          f"main path launched every kernel: {counts}")
    bsz = inputs[0].shape[0]
    check(tuple(dets.shape) == (bsz, 100, 5) and tuple(labels.shape) == (bsz, 100),
          f"predict shapes {tuple(dets.shape)} {tuple(labels.shape)}")
    check(bool(torch.isfinite(dets).all()), "dets finite")
    check(bool(((labels >= -1) & (labels < nc)).all()), f"labels in [-1, {nc - 1}]")
    n_valid = int((labels >= 0).sum())
    check(n_valid > 0, f"{n_valid} valid detections in the batch")
    print("ok: predict ran under torch.cuda.set_sync_debug_mode('error')")
    for im, res in zip(requests, results):
        ok = len(res) == nc and all(r.ndim == 2 and r.shape[1] == 5
                                    and np.isfinite(r).all() for r in res)
        check(ok, f"inference_detector {im.shape[:2]}: {sum(map(len, res))} "
                  "dets in a per-class list")

    # the same candidates through the plain NMS on the card
    with torch.inference_mode():
        outs = handle.model(inputs[0])
        boxes, scores = handle.model.bbox_head.decode_candidates(
            *outs, inputs[1], handle.model.test_cfg)
        from ioudet_torch.models.heads.anchor_head import batched_nms
        kernel_out = batched_nms(boxes, scores, inputs[2], handle.model.test_cfg, True)
        greedy = K.greedy_keep
        K.greedy_keep = lambda b, v, t: K.nms_reduce_plain(K.nms_mask_plain(b, t), v)
        try:
            plain_out = batched_nms(boxes, scores, inputs[2], handle.model.test_cfg, True)
        finally:
            K.greedy_keep = greedy
    check(torch.equal(kernel_out[0], plain_out[0]) and
          torch.equal(kernel_out[1], plain_out[1]) and
          torch.equal(kernel_out[0], dets) and torch.equal(kernel_out[1], labels),
          "dets and labels through the kernels equal the plain-NMS replay")
    return counts


def phase_reference(handle) -> None:
    """Full-width model on a small canvas, GPU against CPU (f32, TF32 off):
    every branch to 2e-3 (f32 sums over 100+ layers in another order)."""
    import copy
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 1, (1, 128, 192, 3)).astype(np.float32))
    with torch.inference_mode():
        gpu = handle.model(x.cuda())
        cpu = copy.deepcopy(handle.model).cpu()(x)
    worst = 0.0
    for g_lvls, c_lvls in zip(gpu, cpu):
        for g, c in zip(g_lvls, c_lvls):
            scale = float(c.abs().max()) + 1e-6
            worst = max(worst, float((g.cpu() - c).abs().max()) / scale)
    check(worst <= 2e-3, f"GPU forward matches CPU forward: max rel err {worst:.2e}")


def phase_timing(K, handle, rng, card: str) -> dict:
    from ioudet_torch.apis.inference import predict

    tag = f"[{card}; f32"
    for tf32 in (False, True):
        set_tf32(tf32)
        for bsz in (1, BATCH):
            inputs = canvases(bsz, rng)
            ms = host_ms(lambda: predict(handle, *inputs), reps=10)
            print(f"predict batch {bsz}: median of 10 {ms:.3f} ms, "
                  f"{bsz * 1e3 / ms:.2f} img/s "
                  f"{tag}, TF32 {'on' if tf32 else 'off'}]", flush=True)
    set_tf32(False)

    _, boxes, valid = nms_cases(2000, BATCH, seed=7)[0]
    b = torch.from_numpy(boxes).cuda()
    v = torch.from_numpy(valid).cuda()
    words = K.nms_mask(b, 0.5)
    times = {
        "nms_mask_kernel": (cuda_ms(lambda: K.nms_mask(b, 0.5), 50),
                            cuda_ms(lambda: K.nms_mask_plain(b, 0.5), 10)),
        "nms_reduce_kernel": (cuda_ms(lambda: K.nms_reduce(words, v), 50),
                              cuda_ms(lambda: K.nms_reduce_plain(words, v), 2, 1)),
    }
    for name, (ms, plain) in times.items():
        print(f"{name} N=2000 batch {BATCH}: kernel {ms:.4f} ms, plain torch "
              f"{plain:.4f} ms {tag}]", flush=True)
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.ops import nms_cuda as K

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t = time.perf_counter()
    K.build()
    print(f"phase 1: built {K.library_path().name} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    set_tf32(False)
    print("phase 2: kernels against plain torch on the card", flush=True)
    err = phase_kernels(K)

    print("phase 3: flagship slice; TF32 off for cuDNN and matmul; "
          "retina_cls.bias zeroed so that random-weight scores clear "
          "score_thr and NMS sees real work", flush=True)
    handle = init_detector(flagship_cfg(), device="cuda", seed=0)
    with torch.no_grad():
        handle.model.bbox_head.retina_cls.bias.zero_()
    rng = np.random.default_rng(0)
    launches = phase_slice(K, handle, canvases(BATCH, rng))
    phase_reference(handle)

    print("phase 4: timings", flush=True)
    times = phase_timing(K, handle, rng, card)
    replaces = {"nms_mask_kernel": "ioudet/ops/nms_pallas.py:26",
                "nms_reduce_kernel": "ioudet/ops/nms_pallas.py:81"}
    kernels = [dict(name=name, route="cuda",
                    source="ioudet_torch/csrc/nms_kernel.cu",
                    replaces=replaces[name], launches=launches[name],
                    max_abs_err=err[name], ms=times[name][0],
                    plain_ms=times[name][1]) for name in replaces]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
