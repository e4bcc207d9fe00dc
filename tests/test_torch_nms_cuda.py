"""The CUDA NMS kernels against their plain torch versions on the card, bit
for bit.  Skips without a GPU.  This file imports no JAX, so a GPU host
without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py
"""

import pytest
import torch

from chip_smoke import nms_cases, nms_edge_cases
from ioudet_torch.ops import nms_cuda


def launched(before: dict) -> dict:
    # the count is shared by every kernel library that is loaded
    return {k: nms_cuda.launches[k] - before[k] for k in ("nms_mask_kernel", "nms_reduce_kernel")}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000])
def test_kernels_match_plain_on_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name, b, v in nms_cases(n, 4, seed=n):
        tb, tv = torch.from_numpy(b).cuda(), torch.from_numpy(v).cuda()
        before = dict(nms_cuda.launches)
        words = nms_cuda.nms_mask(tb, 0.5)
        keep = nms_cuda.nms_reduce(words, tv)
        torch.cuda.synchronize()
        assert launched(before) == {"nms_mask_kernel": 1, "nms_reduce_kernel": 1}
        plain = nms_cuda.nms_mask_plain(tb, 0.5)
        assert torch.equal(words, plain), name
        assert torch.equal(keep, nms_cuda.nms_reduce_plain(plain, tv)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(1, 1), (63, 3), (65, 1), (200, 2), (600, 2), (4100, 1)])
def test_kernels_match_plain_on_the_edges(n, batch):
    """Disjoint boxes (every valid box kept), all invalid, one box
    suppressing every later one, multiclass candidates; N = 600 has three
    column tiles, N = 4100 (65 words) a second slab window.
    Each kernel launches once a call and gives the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name, b, v in nms_edge_cases(n, batch, seed=n) + nms_cases(n, batch, seed=n)[:1]:
        tb, tv = torch.from_numpy(b).cuda(), torch.from_numpy(v).cuda()
        before = dict(nms_cuda.launches)
        keep = nms_cuda.greedy_keep(tb, tv, 0.5)
        torch.cuda.synchronize()
        assert launched(before) == {"nms_mask_kernel": 1, "nms_reduce_kernel": 1}, name
        words = nms_cuda.nms_mask(tb, 0.5)
        plain = nms_cuda.nms_mask_plain(tb, 0.5)
        assert torch.equal(words, plain), name
        assert torch.equal(keep, nms_cuda.nms_reduce_plain(plain, tv)), name
        assert torch.equal(nms_cuda.nms_reduce(words, tv), keep), name
