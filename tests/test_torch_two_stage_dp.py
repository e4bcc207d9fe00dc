"""Faster R-CNN trained data parallel on the CPU: two gloo ranks at batch 2
(tests/_torch_mp_worker.py ``two_stage``, no JAX in the workers) against
one process at the global batch of 4, two ``make_train_step`` steps of the
tiny model of tests/test_torch_two_stage.py with sampling that takes every
candidate (so the ranks' draws select what the one process's do).  The
RPN's sampled-anchor count and the R-CNN's label-weight and positive
counts are the global batch's, so the losses and the parameters agree:
losses rtol 1e-5, parameters rtol 1e-5 / atol 1e-7, as
tests/test_torch_parallel.py.  With the config's ``RandomSampler`` (256
anchors an image) the ranks draw their own samples of the same images:
each rank's step generator has its rank folded in."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from ioudet_torch.models import build_detector
from ioudet_torch.apis.train import step_generator
from tests._torch_mp_worker import (faster_rcnn_cfgs, rpn_sampled_masks, two_stage_batches,
                                    two_stage_steps)
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(the initial model, each rank's pickled outputs) of one two-rank
    gloo job."""
    tmp_path = tmp_path_factory.mktemp("two_stage_dp")
    init = str(tmp_path / "init.pth")
    model = build_detector(*faster_rcnn_cfgs())
    model.init_weights(torch.Generator().manual_seed(0))
    torch.save(model.state_dict(), init)
    port = str(free_port())
    outs = [str(tmp_path / f"rank{r}.pkl") for r in range(WORLD)]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_mp_worker.py"),
                               "two_stage", port, str(r), str(WORLD), init, outs[r]],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed (exit {p.returncode}):\n{logs[r][-6000:]}"
    got = []
    for out in outs:
        with open(out, "rb") as f:
            got.append(pickle.load(f))
    return model, got


def test_two_ranks_equal_one_process(ranks):
    """Two gloo ranks at batch 2 against one process at batch 4: the RPN's
    sampled-anchor count and the R-CNN's label and positive counts are the
    global batch's, so losses and parameters agree."""
    model, outs = ranks
    losses = two_stage_steps(model.train(), two_stage_batches())
    ref = {k: v.numpy() for k, v in model.state_dict().items()}
    for r, got in enumerate(outs):
        assert len(got["losses"]) == len(losses)
        for g, w in zip(got["losses"], losses):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=f"rank {r} {k}")
        for k, v in ref.items():
            np.testing.assert_allclose(got["params"][k], v, rtol=1e-5, atol=1e-7,
                                       err_msg=f"rank {r} {k}")


def test_ranks_draw_their_own_samples(ranks):
    """The RPN's 256-anchor samples of the same two images at step 0: each
    rank draws its own, from the seed with its rank folded in (rank r of 2
    draws what ``manual_seed(r)`` does), and a single process draws rank
    0's."""
    model, outs = ranks
    masks = [got["rpn_masks"] for got in outs]
    for r, m in enumerate(masks):
        assert m.shape[0] == 2
        np.testing.assert_array_equal(m.sum(1), [256, 256], err_msg=f"rank {r}")
        want = rpn_sampled_masks(model, torch.Generator().manual_seed(r))
        np.testing.assert_array_equal(m, want, err_msg=f"rank {r}")
    assert (masks[0] != masks[1]).any(1).all()
    np.testing.assert_array_equal(rpn_sampled_masks(model, step_generator("cpu", 0, 0)),
                                  masks[0])
