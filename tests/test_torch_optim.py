"""The port's optimizers (``ioudet_torch.apis.train.build_optimizer`` and
``clip_grad_norm``) against ioudet's optax chain (``ioudet.apis.train.
build_optimizer``) over 5 steps on the same seeded parameters and gradients:
Adam and AdamW with and without weight decay (decoupled in both, as optax
adds it after ``scale_by_adam``), the config's ``beta1`` / ``beta2``,
gradient clipping by the global norm of the trained parameters, SGD with
momentum and Nesterov, and frozen parameters that get no update and no
state, under a warm-up LR.

Tolerance: rtol 1e-5, atol 1e-7 on the parameters after each step.  torch's
AdamW folds the bias corrections into the step size and the denominator
(lr / (1 - b1^t) and sqrt(v) / sqrt(1 - b2^t) + eps) where optax corrects
the moments first; the same arithmetic in another order, a few f32 ulps an
update of size lr."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from ioudet.apis import train as jtrain
from ioudet_torch.apis import train as ttrain
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

SHAPES = {"backbone.conv1.weight": (4, 3, 3, 3), "backbone.layer1.0.conv1.weight": (4, 4, 1, 1),
          "backbone.layer2.0.conv1.weight": (8, 4, 3, 3), "backbone.layer2.0.bn1.bias": (8,),
          "neck.fpn_convs.0.conv.bias": (8,), "bbox_head.retina_cls.weight": (6, 8, 3, 3)}
FROZEN = ("backbone.conv1.", "backbone.layer1.")
LR_CONFIG = dict(policy="step", warmup="linear", warmup_iters=3, warmup_ratio=1.0 / 3, step=[2])
STEPS = 5


class Params(nn.Module):
    def __init__(self, values: dict):
        super().__init__()
        self.names = list(values)
        for i, v in enumerate(values.values()):
            self.register_parameter(f"p{i}", nn.Parameter(torch.from_numpy(v.copy())))

    def named(self) -> dict:
        return dict(zip(self.names, self.parameters()))


def run_both(opt_cfg: dict, grad_clip):
    rng = np.random.default_rng(7)
    values = {k: rng.normal(0, 0.5, s).astype(np.float32) for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-4, 2)).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(STEPS)]
    trainable = {k: not k.startswith(FROZEN) for k in SHAPES}

    model = Params(values)
    named = model.named()
    for k, p in named.items():
        p.requires_grad_(trainable[k])
    opt = ttrain.build_optimizer(model, opt_cfg)
    sched = ttrain.make_lr_schedule(opt_cfg["lr"], LR_CONFIG, 1, 4)
    trained = [p for g in opt.param_groups for p in g["params"]]

    jsched = jtrain.make_lr_schedule(opt_cfg["lr"], dict(LR_CONFIG), 1, 4)
    tx = jtrain.build_optimizer(dict(opt_cfg), jsched, trainable, grad_clip=grad_clip)
    params = {k: jnp.asarray(v) for k, v in values.items()}
    state = tx.init(params)

    history = []
    for step, g in enumerate(grads):
        for k, p in named.items():
            p.grad = torch.from_numpy(g[k].copy()) if trainable[k] else None
        if grad_clip:
            ttrain.clip_grad_norm(trained, grad_clip["max_norm"])
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        history.append(({k: p.detach().numpy().copy() for k, p in named.items()},
                        {k: np.asarray(v) for k, v in params.items()}))
    return values, trainable, opt, history


CASES = [dict(type=t, lr=1e-3, weight_decay=wd, **betas)
         for t in ("Adam", "AdamW") for wd in (0.0, 1e-2)
         for betas in ({}, dict(beta1=0.8, beta2=0.99))]
CASES += [dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4),
          dict(type="SGD", lr=0.01, momentum=0.9, weight_decay=1e-4, nesterov=True)]


@pytest.mark.parametrize("grad_clip", [None, dict(max_norm=2.0)])
@pytest.mark.parametrize("opt_cfg", CASES)
def test_steps_match_optax_chain(opt_cfg, grad_clip):
    values, trainable, opt, history = run_both(opt_cfg, grad_clip)
    for step, (ours, ref) in enumerate(history):
        for k in SHAPES:
            np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {step + 1} {k}")
            if not trainable[k]:
                np.testing.assert_array_equal(ours[k], values[k])
    # frozen parameters are not the optimizer's and hold no state
    assert len(opt.state) == len(opt.param_groups[0]["params"]) == sum(trainable.values())


def test_adam_reads_betas_and_decouples_the_decay():
    model = Params({"bbox_head.retina_cls.weight": np.ones((2, 2), np.float32)})
    opt = ttrain.build_optimizer(model, dict(type="Adam", lr=1e-3, weight_decay=0.1,
                                             beta1=0.8, beta2=0.95, betas=(0.1, 0.2)))
    assert isinstance(opt, torch.optim.AdamW)
    group = opt.param_groups[0]
    assert group["betas"] == (0.8, 0.95) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.1
    # a zero gradient still decays by lr * wd * p, after (not through) Adam
    p = next(model.parameters())
    p.grad = torch.zeros_like(p)
    opt.step()
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 1e-3 * 0.1, rtol=1e-7)
