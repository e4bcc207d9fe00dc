"""Training API (counterpart of ``ioudet/apis/train.py``).

  * ``make_lr_schedule``: mmcv's LR policy as a plain function of the step
    (per-iteration warm-up, then 'step' or 'cosine' by epoch);
  * ``make_trainable_mask``: the backbone's stem and frozen stages get
    ``requires_grad=False`` (FrozenBN statistics are buffers and never train;
    FrozenBN weights and biases of unfrozen stages do train, as in ``ioudet``);
  * ``build_optimizer``: SGD with momentum (the weight decay added to the
    gradient before the momentum buffer, the LR applied after it), or Adam /
    AdamW as ``ioudet``'s optax chain builds them (the weight decay
    decoupled for both);
  * ``make_train_step``: one function per step: forward, backward, gradient
    clipping, update.  It returns the log dict as device tensors and copies
    nothing to the host;
  * ``Runner`` and ``train_detector``: the epoch loop over a dataset (its
    loader built from ``cfg.data``) or any iterable of batch dicts, with
    logging, checkpoints, resume and an optional validation each epoch.

Low precision follows ``ioudet``'s policy: parameters, gradients, the
losses and the optimizer state are f32; a model built with
``dtype="bfloat16"`` computes its convolutions in bf16 through its own
per-call casts.  There is no loss scaling and no ``torch.autocast``.

Data parallel: one process a device in a ``torch.distributed`` group
(``parallel.init_dist``).  ``ioudet`` computes the loss of the whole global
batch in one program, so every loss is divided by the positive count of the
whole global batch; the port matches it: the anchor head all-reduces the
count before the division, each rank's loss is its share of the global
loss, and the gradients are summed over the ranks (a summing comm hook in
place of DDP's mean).  The logged losses are the global batch's.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from ..data import build_dataloader
from ..data.datasets import ConcatDataset, CustomDataset, RepeatDataset
from ..data.loader import to_device
from ..parallel.mesh import barrier, is_initialized, local_rank, rank, world_size
from ..utils.debug import assert_dtype_policy
from ..utils.logging import get_root_logger
from .checkpoint import latest_checkpoint, load_checkpoint, merge_weights, save_checkpoint

BATCH_KEYS = ("img", "gt_bboxes", "gt_labels", "gt_valid", "img_shape", "pad_shape",
              "gt_bboxes_ignore", "gt_ignore_valid", "gt_masks", "gt_semantic_seg",
              "proposals", "prop_valid")


# --------------------------------------------------------------------------
# optimizer / schedule
# --------------------------------------------------------------------------

def make_lr_schedule(base_lr: float, lr_config: dict, iters_per_epoch: int,
                     total_epochs: int) -> Callable[[int], float]:
    """mmcv LrUpdaterHook semantics: per-iteration warm-up
    (k = (1 - t/warmup_iters) * (1 - ratio); lr = base * (1 - k) for linear),
    then the 'step' or 'cosine' policy by epoch.  ``sched(step) -> float``."""
    policy = lr_config.get("policy", "step")
    warmup = lr_config.get("warmup", None)
    warmup_iters = lr_config.get("warmup_iters", 500)
    warmup_ratio = lr_config.get("warmup_ratio", 1.0 / 3)
    steps = lr_config.get("step", [])
    gamma = lr_config.get("gamma", 0.1)

    def sched(step: int) -> float:
        epoch = step // max(iters_per_epoch, 1)
        if policy == "step":
            mult = gamma ** sum(1 for s in steps if epoch >= s)
        elif policy == "cosine":
            total = total_epochs * iters_per_epoch
            mult = 0.5 * (1 + math.cos(math.pi * step / max(total, 1)))
        else:
            mult = 1.0
        lr = base_lr * mult
        if step < warmup_iters:
            if warmup == "linear":
                lr *= 1.0 - (1.0 - step / warmup_iters) * (1.0 - warmup_ratio)
            elif warmup == "constant":
                lr *= warmup_ratio
            elif warmup == "exp":
                lr *= warmup_ratio ** (1 - step / warmup_iters)
        return lr

    return sched


def make_trainable_mask(model: torch.nn.Module,
                        frozen_stages: Optional[int] = None) -> Dict[str, bool]:
    """Set ``requires_grad`` of every parameter: False for the backbone's
    stem (``frozen_stages >= 0``) and ``layer1..layer{frozen_stages}``, True
    for everything else.  ``frozen_stages`` defaults to the backbone's own.
    Returns name -> trainable."""
    if frozen_stages is None:
        frozen_stages = getattr(getattr(model, "backbone", None), "frozen_stages", -1)
    frozen = ["backbone.conv1.", "backbone.bn1.", "backbone.gn1."] if frozen_stages >= 0 else []
    frozen += [f"backbone.layer{s}." for s in range(1, frozen_stages + 1)]
    mask = {}
    for name, p in model.named_parameters():
        mask[name] = not any(name.startswith(f) for f in frozen)
        p.requires_grad_(mask[name])
    return mask


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict) -> torch.optim.Optimizer:
    """The optimizer of ``ioudet``'s chain over the model's trainable
    parameters (call ``make_trainable_mask`` first: a frozen parameter gets
    no state and no update).  The LR is set per step by the train step.

      * SGD: ``torch.optim.SGD`` adds ``weight_decay * p`` to the gradient,
        folds the result into the momentum buffer and applies the LR last,
        the order of optax's ``add_decayed_weights``, ``trace``, LR.
      * Adam and AdamW alike: optax's ``scale_by_adam`` (the config's
        ``beta1`` / ``beta2``, eps 1e-8 outside the square root), then
        ``weight_decay * p`` added to that update, then the LR: the decay is
        decoupled, which is ``torch.optim.AdamW``'s rule, for both names.
        (``torch.optim.Adam``'s ``weight_decay`` adds to the gradient
        instead.)"""
    cfg = dict(optimizer_cfg)
    opt_type = cfg.pop("type", "SGD")
    params = [p for p in model.parameters() if p.requires_grad]
    lr, wd = cfg.get("lr", 0.01), cfg.get("weight_decay", 0.0)
    if opt_type == "SGD":
        return torch.optim.SGD(params, lr=lr, momentum=cfg.get("momentum", 0.9),
                               weight_decay=wd, nesterov=cfg.get("nesterov", False))
    if opt_type in ("Adam", "AdamW"):
        return torch.optim.AdamW(params, lr=lr, betas=(cfg.get("beta1", 0.9),
                                                       cfg.get("beta2", 0.999)),
                                 eps=1e-8, weight_decay=wd)
    raise KeyError(f"unsupported optimizer {opt_type}")


def clip_grad_norm(params: Iterable[torch.nn.Parameter], max_norm: float) -> torch.Tensor:
    """Scale the gradients so that their global L2 norm is at most
    ``max_norm``; returns the norm before clipping.  On the device: no host
    copy decides whether to clip."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def parse_losses(losses: Dict[str, torch.Tensor]):
    """total = the sum of every entry whose key contains 'loss'; the log dict
    is the entries plus ``loss`` = total."""
    total = sum(v for k, v in losses.items() if "loss" in k)
    log_vars = dict(losses)
    log_vars["loss"] = total
    return total, log_vars


# --------------------------------------------------------------------------
# train step
# --------------------------------------------------------------------------

class _ForwardTrain(nn.Module):
    """The detector with ``forward_train`` as its forward, for DDP to wrap
    (DDP's hooks run around ``forward``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.forward_train(*args, **kwargs)


def _sum_gradients(group, bucket):
    """DDP comm hook: the gradients summed over the ranks, not averaged
    (each rank's loss is already its share of the global batch's)."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def data_parallel(model: nn.Module) -> DistributedDataParallel:
    """``model.forward_train`` wrapped in DDP over the default group, with
    summed gradients.  On a card, ``device_ids`` is the model's device.
    Every trainable parameter gets a gradient every step, so
    ``find_unused_parameters`` stays off; FrozenBN's statistics never change
    and GHM's EMA sums move alike on every rank (their counts are summed
    over the ranks), so no buffers are broadcast."""
    device = next(model.parameters()).device
    ddp = DistributedDataParallel(
        _ForwardTrain(model), device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)
    ddp.register_comm_hook(None, _sum_gradients)
    return ddp


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of one train step's draws (anchor and roi sampling):
    seeded from the run's seed, the step and this rank, on the model's
    device, so a resumed run draws what an unbroken one would and each
    rank's images get their own draws (``ioudet`` splits a key per image of
    the global batch).  Outside a process group the rank is 0 of 1."""
    return torch.Generator(device).manual_seed((seed * 2 ** 32 + step) * world_size() + rank())


def make_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    lr_schedule: Callable[[int], float],
                    grad_clip: Optional[dict] = None, seed: int = 0) -> Callable:
    """``train_step(batch, step) -> log dict`` of detached device tensors.

    batch keys: img, gt_bboxes, gt_labels, gt_valid, img_shape, pad_shape
    (+ gt_bboxes_ignore, gt_ignore_valid; + gt_masks, (B, G, S, S) uint8
    box-frame crops, for a mask detector; + gt_semantic_seg, (B, h, w) int
    labels at the semantic head's stride, for a detector with one; +
    proposals (B, P, 4), prop_valid (B, P) for one that ``requires_proposals``),
    tensors on the model's device;
    ``step`` is the number of steps taken so far and picks the LR and the
    generator of the step's draws (``step_generator(device, seed, step)``,
    ``ioudet``'s ``fold_in(key, step)``).  The parameters must be f32 (a
    bf16 model computes in bf16 and keeps f32 parameters).  In a process
    group the model runs under ``data_parallel`` (``train_step.ddp``; None
    without a group), the batch is this rank's share, and the log dict
    holds the global batch's losses (summed over the ranks)."""
    assert_dtype_policy(model)
    params = [p for group in optimizer.param_groups for p in group["params"]]
    ddp = data_parallel(model) if is_initialized() else None
    forward = model.forward_train if ddp is None else ddp
    device = next(model.parameters()).device
    with_masks = getattr(model, "mask_head", None) is not None
    with_semantic = getattr(model, "semantic_head", None) is not None
    with_proposals = getattr(model, "requires_proposals", False)

    def train_step(batch: dict, step: int) -> Dict[str, torch.Tensor]:
        lr = lr_schedule(step)
        for group in optimizer.param_groups:
            group["lr"] = lr
        kw = dict(generator=step_generator(device, seed, step))
        if "gt_bboxes_ignore" in batch:
            kw.update(gt_bboxes_ignore=batch["gt_bboxes_ignore"],
                      gt_ignore_valid=batch["gt_ignore_valid"])
        if with_masks and "gt_masks" in batch:
            kw["gt_masks"] = batch["gt_masks"]
        if with_semantic and "gt_semantic_seg" in batch:
            kw["gt_semantic_seg"] = batch["gt_semantic_seg"]
        if with_proposals:
            kw.update(proposals=batch["proposals"], prop_valid=batch["prop_valid"])
        losses = forward(
            batch["img"], batch["gt_bboxes"], batch["gt_labels"], batch["gt_valid"],
            batch["img_shape"], batch["pad_shape"], **kw)
        total, log_vars = parse_losses(losses)
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        if grad_clip:
            clip_grad_norm(params, grad_clip.get("max_norm", 35))
        optimizer.step()
        log_vars = {k: v.detach() for k, v in log_vars.items()}
        if world_size() > 1:
            stacked = torch.stack([v.float() for v in log_vars.values()])
            dist.all_reduce(stacked)
            log_vars = dict(zip(log_vars, stacked.unbind()))
        return log_vars

    train_step.ddp = ddp
    return train_step


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

class Runner:
    """Epoch runner: a log record every ``log_interval`` iterations (the only
    place that copies losses to the host), a checkpoint every
    ``checkpoint_interval`` epochs, ``step_hook(step, log_vars)`` after every
    step, ``eval_hook(model) -> metrics`` after every epoch (logged as
    mode 'val').

    In a process group, rank 0 alone writes ``log.json``, the checkpoints
    and the TensorBoard events; every rank runs the eval hook (which merges
    the ranks' results) and resumes from the same checkpoint.  With
    ``tensorboard`` the records also go to ``<work_dir>/tf_logs`` through
    ``torch.utils.tensorboard`` where the ``tensorboard`` package is
    installed, and a warning says so where it is not."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 train_step: Callable, work_dir: str, log_interval: int = 50,
                 checkpoint_interval: int = 1,
                 lr_schedule: Optional[Callable[[int], float]] = None,
                 meta: Optional[dict] = None,
                 step_hook: Optional[Callable] = None,
                 eval_hook: Optional[Callable] = None,
                 tensorboard: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.train_step = train_step
        self.work_dir = work_dir
        self.log_interval = log_interval
        self.checkpoint_interval = checkpoint_interval
        self.lr_schedule = lr_schedule
        self.meta = meta or {}
        self.step_hook = step_hook
        self.eval_hook = eval_hook
        self.logger = get_root_logger()
        self.step = 0
        self.epoch = 0
        self.device = next(model.parameters()).device
        self.is_writer = rank() == 0
        os.makedirs(work_dir, exist_ok=True)
        self.log_file = os.path.join(work_dir, "log.json")
        self.tb_writer = None
        if tensorboard and self.is_writer:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self.tb_writer = SummaryWriter(os.path.join(work_dir, "tf_logs"))
            except ImportError:
                self.logger.warning("tensorboard is not installed; TensorBoard logging off")

    def resume(self, path: Optional[str] = None) -> bool:
        """Load the model, the optimizer, the step and the epoch from ``path``
        (a ``.pth`` or an ``ioudet`` checkpoint directory; by default the one
        ``<work_dir>/latest`` names).  False where there is none."""
        path = path or latest_checkpoint(self.work_dir)
        if not path or not os.path.exists(path):
            return False
        meta = load_checkpoint(self.model, path, optimizer=self.optimizer)
        self.epoch = int(meta.get("epoch", 0))
        self.step = int(meta.get("step", 0))
        self.logger.info(f"resumed from {path} at epoch {self.epoch}, step {self.step}")
        return True

    def save(self, name: str) -> Optional[str]:
        """Rank 0 writes the checkpoint; every rank waits for it."""
        path = None
        if self.is_writer:
            meta = dict(self.meta, epoch=self.epoch + 1, step=self.step)
            path = save_checkpoint(self.work_dir, name, self.model, self.optimizer, meta)
            self.logger.info(f"saved checkpoint {path}")
        barrier()
        return path

    def _log(self, record: dict) -> None:
        self.logger.info(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                  for k, v in record.items()))
        if not self.is_writer:
            return
        with open(self.log_file, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
        if self.tb_writer is not None:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "iter", "step"):
                    self.tb_writer.add_scalar(f"{record.get('mode', 'train')}/{k}", float(v),
                                              int(record.get("step", self.step)))
            self.tb_writer.flush()

    def _to_device(self, batch: dict) -> dict:
        return {k: to_device(batch[k], self.device) for k in BATCH_KEYS if k in batch}

    def run(self, loader: Iterable[dict], total_epochs: int) -> "Runner":
        self.model.train()
        for epoch in range(self.epoch, total_epochs):
            self.epoch = epoch
            if hasattr(loader, "set_epoch"):
                loader.set_epoch(epoch)
            t_data = time.time()
            for i, batch in enumerate(loader):
                batch = self._to_device(batch)
                data_time = time.time() - t_data
                log_vars = self.train_step(batch, self.step)
                self.step += 1
                if self.step_hook is not None:
                    self.step_hook(self.step, log_vars)
                if (i + 1) % self.log_interval == 0:
                    rec = dict(mode="train", epoch=epoch + 1, iter=i + 1,
                               step=self.step, data_time=round(data_time, 4))
                    rec.update({k: float(v) for k, v in log_vars.items()})
                    rec["time"] = round(time.time() - t_data, 4)
                    if self.lr_schedule is not None:
                        rec["lr"] = self.lr_schedule(self.step)
                    self._log(rec)
                t_data = time.time()
            if (epoch + 1) % self.checkpoint_interval == 0:
                self.save(f"epoch_{epoch + 1}")
            if self.eval_hook is not None:
                self.model.eval()
                self._log(dict(mode="val", epoch=epoch + 1, **self.eval_hook(self.model)))
                self.model.train()
        if self.tb_writer is not None:
            self.tb_writer.close()
        return self


# --------------------------------------------------------------------------
# top-level entry
# --------------------------------------------------------------------------

def train_detector(model, data, cfg, work_dir: str,
                   resume_from: Optional[str] = None, auto_resume: bool = True,
                   device="cuda", step_hook: Optional[Callable] = None,
                   seed: int = 0, validate: bool = False, val_dataset=None,
                   load_from: Optional[str] = None,
                   n_devices: Optional[int] = None) -> Runner:
    """Train ``model`` (a detector or a ``DetectorHandle``) under the
    config's ``optimizer``, ``optimizer_config``, ``lr_config``,
    ``total_epochs``, ``log_config`` (``interval``, ``tensorboard``) and
    ``checkpoint_config``.

    ``data`` is a dataset of the port's data pipeline, whose loader is built
    from ``cfg.data`` (``imgs_per_gpu`` images a rank, ``workers_per_gpu``;
    shuffled from ``seed``, ragged tail dropped, this rank's shard of the
    batches), or any sized iterable of batch dicts with the keys of
    ``BATCH_KEYS`` (in a process group: this rank's share of each global
    batch).  ``seed`` seeds the loader's shuffle and each step's draws.
    With ``validate`` and a ``val_dataset``, each epoch ends with
    ``multi_host_test`` and ``evaluate`` on it.

    Runs on ``device``; a CUDA device that is not there raises.  In a
    process group of N ranks (``parallel.init_dist``) the step is data
    parallel and ``n_devices``, where given, must be N; "cuda" means
    ``cuda:LOCAL_RANK``.  ``load_from`` (or the config's): weights only, a
    ``.pth`` or an ``ioudet`` checkpoint directory, merged over the model's
    own.  ``resume_from`` (or with ``auto_resume`` the work dir's latest):
    weights, optimizer state, step and epoch.  Returns the Runner
    (``.model``, ``.optimizer``, ``.step``)."""
    model = getattr(model, "model", model)
    world = world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world} "
                         "rank(s); start one process a device (tools/train.py --n-devices, "
                         "or torchrun)")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None and world > 1:
            device = torch.device("cuda", local_rank())
    logger = get_root_logger()
    model.to(device)
    load_from = load_from or cfg.get("load_from")
    if load_from:
        names = merge_weights(model, load_from)
        logger.info(f"loaded {len(names)} tensors from {load_from}")
    loader = data
    if isinstance(data, (CustomDataset, ConcatDataset, RepeatDataset)):
        data_cfg = dict(cfg.get("data") or {})
        loader = build_dataloader(data, data_cfg.get("imgs_per_gpu", 2),
                                  data_cfg.get("workers_per_gpu", 2), shuffle=True, seed=seed)
    total_epochs = cfg.get("total_epochs", 12)
    sched = make_lr_schedule(cfg["optimizer"]["lr"], dict(cfg.get("lr_config", {})),
                             len(loader), total_epochs)
    make_trainable_mask(model)
    optimizer = build_optimizer(model, dict(cfg["optimizer"]))
    grad_clip = dict(cfg.get("optimizer_config") or {}).get("grad_clip")
    step_fn = make_train_step(model, optimizer, sched, grad_clip, seed)
    eval_hook = None
    if validate and val_dataset is not None:
        from .test import make_eval_hook
        eval_hook = make_eval_hook(val_dataset)
    meta = dict(config=getattr(cfg, "text", ""), CLASSES=getattr(data, "CLASSES", None))
    log_cfg = dict(cfg.get("log_config", {}))
    runner = Runner(model, optimizer, step_fn, work_dir,
                    log_interval=log_cfg.get("interval", 50),
                    checkpoint_interval=dict(cfg.get("checkpoint_config", {})).get("interval", 1),
                    lr_schedule=sched, meta=meta, step_hook=step_hook, eval_hook=eval_hook,
                    tensorboard=log_cfg.get("tensorboard", False))
    if resume_from:
        runner.resume(resume_from)
    elif auto_resume:
        runner.resume()
    return runner.run(loader, total_epochs)
