"""The CUDA NMS kernels against their plain torch versions on the card, bit
for bit.  Skips without a GPU.  This file imports no JAX, so a GPU host
without it runs it as

    python -m pytest --noconftest -m cuda tests/test_torch_nms_cuda.py
"""

import pytest
import torch

from chip_smoke import nms_cases
from ioudet_torch.ops import nms_cuda


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
        # the count is shared by every kernel library that is loaded
        assert {k: nms_cuda.launches[k] - before[k]
                for k in ("nms_mask_kernel", "nms_reduce_kernel")} == \
            {"nms_mask_kernel": 1, "nms_reduce_kernel": 1}
        plain = nms_cuda.nms_mask_plain(tb, 0.5)
        assert torch.equal(words, plain), name
        assert torch.equal(keep, nms_cuda.nms_reduce_plain(plain, tv)), name
