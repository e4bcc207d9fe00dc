"""Port parity of HTC without the semantic branch on the CPU
(``configs/htc_without_semantic_r50_fpn_1x.py``'s flags: interleaving and
mask information flow on, no semantic head): tests/test_torch_htc.py's
tiny model and helpers at this setting, in a file of its own so that each
file compiles one or two ``ioudet`` programs.  Held against ``ioudet`` on
the same seeded inputs: the bridge (``conv_res`` in stages 1-2, no
semantic head), ``simple_test`` (dets, labels, masks) and every train
loss.  Tolerances: tests/test_torch_htc.py's."""

import pytest

from tests.test_torch_htc import (check_bridge, check_simple_test, check_train_losses,
                                  htc_params, htc_twin)
from tests.torch_twins import one_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def twins():
    return htc_twin("without_semantic", htc_params())


def test_bridge_has_conv_res_and_no_semantic_head(twins):
    check_bridge("without_semantic", twins[0])


@pytest.mark.parametrize("seed", [2, 3])
def test_simple_test_matches_ioudet(twins, seed):
    check_simple_test(*twins, seed)


def test_train_losses_match_ioudet(twins):
    check_train_losses("without_semantic", *twins)
