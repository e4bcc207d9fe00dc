"""The spread of the multiclass recipe of tests/test_convergence_multiclass.py
over seeds, on the CPU, for either package: train, then evaluate as the
test does (the exact and the production decode, in f32 and with calibrated
static int8 convs) and print AP / AP50 / AP75 of the four runs a seed.

    python -m tests.recipe_spread jax 0 1 2 3     # ioudet, the test's own data
    python -m tests.recipe_spread torch 0 1 2 3   # the port, chip_smoke's recipe

``jax`` runs the test's own config and JPEG images on two virtual devices
(batch 8 a device), with ``train_detector(..., seed=s)`` (the seed of the
initial weights and of the loader).  ``torch`` runs chip_smoke.py's
``recipe_cfg`` on its .ppm images (the same pixels before JPEG) at batch 16
on one device, weights from ``init_detector(seed=s)`` and the loader from
``train_detector(seed=s)``, evaluated by chip_smoke.py's ``recipe_runs``.
Not a test: a seed takes minutes.
"""

import contextlib
import io
import os
import pathlib
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_jax(seed: int, root: str) -> dict:
    import tests.conftest  # noqa: F401  the CPU with 8 virtual devices
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ioudet.apis import single_device_test, train_detector
    from ioudet.data import build_dataset
    from ioudet.models import build_detector
    from ioudet.ops.quant import calibrate, quantize_calls
    from ioudet.utils.config import Config
    import chip_smoke
    from tests.test_convergence_multiclass import planted_multiclass_coco

    class Factory:   # pytest's tmp_path_factory, as the fixture uses it
        def mktemp(self, name):
            path = pathlib.Path(root) / name
            path.mkdir()
            return path

    ann, img_dir = planted_multiclass_coco.__wrapped__(Factory())
    cfg = chip_smoke.recipe_cfg(ann, img_dir)   # the test's own config
    cfg["data"]["imgs_per_gpu"] = 8   # on two devices
    cfg = Config.fromdict(dict(cfg, work_dir=os.path.join(root, "work")))
    det = build_detector(dict(cfg.model), cfg.get("train_cfg"), cfg.get("test_cfg"))
    state = train_detector(det, build_dataset(cfg.data["train"]), cfg, cfg.work_dir,
                           n_devices=2, seed=seed)
    val = build_dataset(cfg.data["val"])
    params = jax.tree.map(jnp.asarray, state["params"])
    prod = build_detector(dict(cfg.model), cfg.get("train_cfg"), chip_smoke.RECIPE_PROD_CFG)

    def evaluate(detector) -> dict:
        with contextlib.redirect_stdout(io.StringIO()):
            return val.evaluate(single_device_test(detector, params, val, imgs_per_batch=8,
                                                   progress=False))

    runs = {"exact": evaluate(det), "production": evaluate(prod)}
    calib = jnp.asarray(np.stack([val[i]["img"] for i in range(2)]))
    scales = calibrate(lambda x: det.apply({"params": params}, x), [calib])
    with quantize_calls(act_scale=scales):
        runs["int8 exact"], runs["int8 production"] = evaluate(det), evaluate(prod)
    return runs


def run_torch(seed: int, root: str) -> dict:
    import chip_smoke
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.train import train_detector
    from ioudet_torch.data import build_dataset
    from ioudet_torch.ops import quant as Q

    cfg = chip_smoke.recipe_cfg(*chip_smoke.plant_multiclass(root))
    handle = init_detector(cfg, device="cpu", seed=seed)
    train_detector(handle, build_dataset(cfg["data"]["train"]), cfg,
                   os.path.join(root, "work"), device="cpu", seed=seed)
    return chip_smoke.recipe_runs(Q, handle, build_dataset(cfg["data"]["val"]))


def main(argv) -> None:
    package, seeds = argv[0], [int(s) for s in argv[1:]]
    run = {"jax": run_jax, "torch": run_torch}[package]
    for seed in seeds:
        with tempfile.TemporaryDirectory() as root:
            runs = run(seed, root)
        for name, m in runs.items():
            print(f"{package} seed {seed}, {name} decode: AP {m['AP']!r}, AP50 "
                  f"{m['AP50']!r}, AP75 {m['AP75']!r}", flush=True)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main(sys.argv[1:])
