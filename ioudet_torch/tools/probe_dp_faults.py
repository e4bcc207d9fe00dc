"""How far the data-parallel check of ``chip_smoke.py`` (phase 8b) moves
when the ranks get the normalisation wrong, on one NVIDIA GPU.

    python -m ioudet_torch.tools.probe_dp_faults

8b trains two ranks on cuda:0 over gloo and holds their logged losses and
parameters against one process at the global batch.  This probe runs the
same job with one fault planted in the ranks at run time (the one process
stays sound; no source is changed):

  * ``none``: no fault, the reading of a sound run;
  * ``mean``: the summing comm hook is not registered, so DDP averages the
    ranks' gradients (each rank's loss is already its share of the global
    batch's, so every gradient is halved);
  * ``local``: the positive count is not all-reduced, so each rank divides
    its loss by its own positives, as mmdet's DDP does.

Each fault runs with the flagship's gradient clip (max_norm 35, as 8b
runs) and with the clip off (max_norm 1e30: the norm is still read).  A
clip hides a gradient's scale where both norms are above it.  The result
is one JSON object a run: each step's largest relative loss gap, the
parameters' worst share of the limit at 1e-3 and 1e-2 of each tensor's
change (plus two f32 steps at its scale, as 8b), and the global gradient
norms before the clip, with the card's name and power limit.  Run it from
the root of the repo: the job is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FAULTS = ("none", "mean", "local")
CLIPS = ("35", "off")


def cfg_for(clip: str):
    """``chip_smoke.dp_cfg``, with the clip off where ``clip`` is "off"."""
    def dp_cfg(cfg: dict) -> dict:
        cfg = dict(cfg, total_epochs=1, log_config=dict(interval=1))
        if clip == "off":
            cfg["optimizer_config"] = dict(grad_clip=dict(max_norm=1e30))
        return cfg
    return dp_cfg


def record_norms() -> list:
    """Wrap the trainer's clip so that every global norm it reads is kept."""
    import ioudet_torch.apis.train as T
    norms, clip = [], T.clip_grad_norm

    def recorded(params, max_norm):
        norm = clip(params, max_norm)
        norms.append(norm.detach().clone())
        return norm
    T.clip_grad_norm = recorded
    return norms


def rank_main(argv: list) -> int:
    """One rank: ``chip_smoke.dp_rank_main`` with PROBE_FAULT planted and
    PROBE_CLIP's config; the norms go beside its output."""
    fault, clip = os.environ["PROBE_FAULT"], os.environ["PROBE_CLIP"]
    cs.dp_cfg = cfg_for(clip)
    if fault == "mean":
        from torch.nn.parallel import DistributedDataParallel
        DistributedDataParallel.register_comm_hook = lambda self, *args, **kwargs: None
    elif fault == "local":
        import ioudet_torch.models.heads.anchor_head as anchor_head
        anchor_head.world_size = lambda: 1
    norms = record_norms()
    rc = cs.dp_rank_main(argv)
    with open(os.path.join(argv[4], f"norms{argv[0]}.json"), "w") as f:
        json.dump([float(n) for n in norms], f)
    return rc


def worst_param(ranks: list, start: dict, params: dict, tol: float) -> tuple:
    """8b's parameter reading at limit ``tol``: the worst share, its tensor."""
    worst, name = 0.0, ""
    for o in ranks:
        for k, v in o["params"].items():
            diff = float((v - params[k]).abs().max())
            limit = tol * float((params[k] - start[k]).abs().max()) + \
                2.0 ** -22 * float(params[k].abs().max())
            if diff / limit > worst:
                worst, name = diff / limit, k
    return worst, name


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dp_faults needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from ioudet_torch.apis.inference import init_detector
    from ioudet_torch.apis.train import train_detector

    cs.__file__ = os.path.abspath(__file__)   # the ranks start this probe
    card = cs.card_line()
    norms = record_norms()
    for clip in CLIPS:
        cs.set_tf32(False)
        cfg = cs.flagship_cfg()
        handle = init_detector(cfg, device="cuda", seed=0)
        start = {k: v.detach().to("cpu", copy=True) for k, v in handle.model.named_parameters()}
        one: list = []
        norms.clear()
        with tempfile.TemporaryDirectory() as work_dir:
            train_detector(handle, cs.dp_batches(), cfg_for(clip)(cfg), work_dir, device="cuda",
                           step_hook=lambda step, log_vars: one.append(
                               {k: float(v) for k, v in log_vars.items()}))
        params = {k: v.detach().to("cpu", copy=True) for k, v in handle.model.named_parameters()}
        one_norms = [float(n) for n in norms]
        del handle
        torch.cuda.empty_cache()
        for fault in FAULTS:
            os.environ.update(PROBE_CLIP=clip, PROBE_FAULT=fault)
            with tempfile.TemporaryDirectory() as tmp:
                ranks = cs.finish_ranks(cs.start_ranks(cs.DP_WORLD, "gloo", tmp))
                rank_norms = []
                for r in range(cs.DP_WORLD):
                    with open(os.path.join(tmp, f"norms{r}.json")) as f:
                        rank_norms.append(json.load(f))
            loss_gap = [max(abs(o["losses"][i][k] - one[i][k]) / abs(one[i][k])
                            for o in ranks for k in one[i]) for i in range(cs.DP_STEPS)]
            print(json.dumps(dict(
                clip=clip, fault=fault, loss_gap=loss_gap,
                param_share={f"{tol:g}": worst_param(ranks, start, params, tol)
                             for tol in (1e-3, 1e-2)},
                one_norms=one_norms, rank_norms=rank_norms, card=card)), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
