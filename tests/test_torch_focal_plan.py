"""The focal kernels' planner on the CPU: which run of positions a thread
loads (``sum_vector``; ``dx_vector`` for the dx kernel, which also asks dx's
base address) and how the level is cut into units and blocks (``sum_plan``,
for both kernels), for the flagship's five levels at batch 8 in f32 and
bf16, as the permuted NCHW view the heads return and contiguous, and on
ragged shapes; and the parts probe's cuts of the kernel source.  Imports no
JAX."""

import pytest
import torch

from ioudet_torch.ops import focal_cuda
from ioudet_torch.tools import probe_focal_parts
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

LEVELS = ((104, 168), (52, 84), (26, 42), (13, 21), (7, 11))   # P3-P7 at 832x1344
SMS = 132
# V of P3-P7 at batch 8 on the permuted NCHW view: 16-byte runs where H*W
# allows (4 f32, 8 bf16), shorter ones at bf16 P5 (H*W = 1092 = 4 x 273),
# scalar loads at the odd P6 (273) and P7 (77)
VIEW_VEC = {torch.float32: (4, 4, 4, 1, 1), torch.bfloat16: (8, 8, 4, 1, 1)}


def level(h, w, dtype, layout, b=8, a=9, c=80):
    """(dims, strides, itemsize) of a level's (B, H, W, A*C) logits."""
    x = torch.empty(b, a * c, h, w, dtype=dtype).permute(0, 2, 3, 1)
    if layout == "contiguous":
        x = x.contiguous()
    return (b, h, w, a, c), x.stride(), x.element_size()


def busiest(dims, vec, chunk, wave):
    """The busiest thread's work, in classes, when the units are dealt over a
    wave."""
    b, h, w, a, c = dims
    units = b * a * (h * w // vec) * -(-c // chunk)
    return -(-units // wave) * (chunk + focal_cuda.UNIT_COST)


def least_busiest(dims, vec, wave):
    """The least of busiest() over every chunk of at least MIN_CHUNK classes,
    and over all C classes."""
    c = dims[4]
    return min(busiest(dims, vec, k, wave) for k in range(min(c, focal_cuda.MIN_CHUNK), c + 1))


@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_run_length_on_the_flagship_levels(dtype, layout):
    got = tuple(focal_cuda.sum_vector(*level(h, w, dtype, layout), 0) for h, w in LEVELS)
    assert got == (VIEW_VEC[dtype] if layout == "view" else (1,) * 5)


@pytest.mark.parametrize("resident", [1, 4, 8])
@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_is_one_wave_and_fills_it(dtype, layout, resident):
    """Every level gets at most one wave of blocks and the chunk that leaves
    its busiest thread the fewest classes; a level with units enough for a
    wave gets all of it, and its busiest thread's work is within 10% of its
    even share."""
    wave = SMS * resident * focal_cuda.SUM_THREADS
    for h, w in LEVELS:
        dims, strides, itemsize = level(h, w, dtype, layout)
        vec = focal_cuda.sum_vector(dims, strides, itemsize, 0)
        chunk, blocks = focal_cuda.sum_plan(dims, vec, SMS, resident)
        b, _, _, a, c = dims
        units = b * a * (h * w // vec) * -(-c // chunk)
        assert 1 <= blocks <= SMS * resident
        assert blocks == min(SMS * resident, -(-units // focal_cuda.SUM_THREADS))
        assert c % chunk == 0 or chunk >= focal_cuda.MIN_CHUNK
        assert busiest(dims, vec, chunk, wave) == least_busiest(dims, vec, wave)
        if units >= wave:
            assert blocks == SMS * resident
            share = b * a * (h * w // vec) * -(-c // chunk) * (chunk + focal_cuda.UNIT_COST) / wave
            assert busiest(dims, vec, chunk, wave) <= 1.1 * share


def test_plan_at_p3_f32_batch_8():
    """P3's 314,496 runs of 4 at batch 8: with 8 blocks an SM the 80 classes
    go in chunks of 16 (6 of the 5.8 units a thread: 108 for the busiest
    against 164 unsplit); with 5 (the card's count) unsplit, in 2 of the 1.86
    units a thread; with 2 in chunks of 27 (14 of the 13.96 units a thread)."""
    dims, strides, itemsize = level(104, 168, torch.float32, "view")
    assert focal_cuda.sum_plan(dims, 4, SMS, 8) == (16, SMS * 8)
    assert busiest(dims, 4, 16, SMS * 8 * 256) == 108
    assert busiest(dims, 4, 80, SMS * 8 * 256) == 164
    assert focal_cuda.sum_plan(dims, 4, SMS, 5) == (80, SMS * 5)
    assert focal_cuda.sum_plan(dims, 4, SMS, 2) == (27, SMS * 2)


@pytest.mark.parametrize("vec", [1, 2, 4])
def test_plan_chunk_is_the_best_of_all_chunks(vec):
    """The chosen chunk gives the busiest thread no more work than any other
    chunk of at least MIN_CHUNK classes, on a level off every grid."""
    dims = (3, 10, 12, 5, 37)
    for resident in (1, 3, 8):
        wave = 2 * resident * focal_cuda.SUM_THREADS
        chunk, _ = focal_cuda.sum_plan(dims, vec, 2, resident)
        assert busiest(dims, vec, chunk, wave) == least_busiest(dims, vec, wave)


@pytest.mark.parametrize("shape, itemsize, address, want", [
    ((2, 6, 9, 3, 7), 4, 0, 2),      # H*W = 54: runs of 2
    ((3, 5, 7, 9, 80), 4, 0, 1),     # H*W = 35, odd
    ((2, 6, 7, 3, 5), 4, 0, 2),      # a plane pitch of 168 bytes
    ((3, 2, 6, 9, 80), 4, 0, 4),     # 48 bytes: runs of 4 f32 ...
    ((3, 2, 6, 9, 80), 2, 0, 4),     # ... and of 4 bf16, not 8
    ((2, 4, 8, 9, 80), 2, 0, 8),
    ((1, 4, 4, 1, 1), 4, 0, 4),      # A = C = B = 1
    ((1, 4, 4, 1, 1), 2, 0, 8),
    ((1, 3, 3, 1, 1), 4, 0, 1),
    ((1, 1, 1, 1, 1), 4, 0, 1),
    ((2, 4, 8, 9, 80), 4, 4, 1),     # a base off the grid of the run
    ((2, 4, 8, 9, 80), 4, 8, 2),
    ((2, 4, 8, 9, 80), 2, 8, 4),
])
def test_run_length_on_ragged_shapes(shape, itemsize, address, want):
    b, h, w, a, c = shape
    strides = (a * c * h * w, w, 1, h * w)   # the permuted NCHW view
    assert focal_cuda.sum_vector(shape, strides, itemsize, address) == want


def test_run_length_needs_positions_on_the_unit_stride():
    """Strides where neighbouring positions are not neighbours in memory
    (a transposed plane, a padded row, the NHWC layout) take scalar loads."""
    dims = (2, 8, 16, 9, 80)
    hw = 8 * 16
    assert focal_cuda.sum_vector(dims, (720 * hw, 16, 1, hw), 4, 0) == 4
    assert focal_cuda.sum_vector(dims, (720 * hw, 1, 8, hw), 4, 0) == 1
    assert focal_cuda.sum_vector(dims, (720 * 8 * 20, 20, 1, 8 * 20), 4, 0) == 1
    assert focal_cuda.sum_vector(dims, (720 * hw, 16 * 720, 720, 1), 4, 0) == 1
    # an image stride off the grid of the run
    assert focal_cuda.sum_vector(dims, (720 * hw + 2, 16, 1, hw), 4, 0) == 2


@pytest.mark.parametrize("layout", ["view", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dx_run_length_on_the_flagship_levels(dtype, layout):
    """dx takes the sum's runs where both base addresses lie on the grid of
    a 16-byte run (a fresh allocation does)."""
    got = tuple(focal_cuda.dx_vector(*level(h, w, dtype, layout), 0, 512) for h, w in LEVELS)
    assert got == (VIEW_VEC[dtype] if layout == "view" else (1,) * 5)


@pytest.mark.parametrize("itemsize, dx_address, want", [
    (4, 4, 1), (4, 8, 2), (4, 16 + 8, 2), (4, 32, 4),
    (2, 2, 1), (2, 4, 2), (2, 8, 4), (2, 48, 8)])
def test_dx_base_off_the_grid_shrinks_the_run(itemsize, dx_address, want):
    """dx shares the logits' strides but not their allocation: a dx base off
    the run's grid shrinks V as a logits base would, whichever of the two it
    is (P3's view, where the strides allow 16-byte runs)."""
    dims = (8, 104, 168, 9, 80)
    strides = (720 * 104 * 168, 168, 1, 104 * 168)
    assert focal_cuda.dx_vector(dims, strides, itemsize, 0, dx_address) == want
    assert focal_cuda.dx_vector(dims, strides, itemsize, dx_address, 0) == want
    assert focal_cuda.sum_vector(dims, strides, itemsize, 0) == 16 // itemsize


@pytest.mark.parametrize("resident", [3, 4, 6])
def test_dx_plan_is_one_wave_and_fills_it(resident):
    """The dx kernel's plan on its own run (here a dx base off the 16-byte
    grid: runs of 2 f32) and resident count: at most one wave, all of it
    where the units suffice, the chunk that leaves the busiest thread the
    fewest classes."""
    wave = SMS * resident * focal_cuda.SUM_THREADS
    for h, w in LEVELS:
        dims, strides, itemsize = level(h, w, torch.float32, "view")
        vec = focal_cuda.dx_vector(dims, strides, itemsize, 0, 8)
        assert vec == (2 if (h * w) % 2 == 0 else 1)
        chunk, blocks = focal_cuda.sum_plan(dims, vec, SMS, resident)
        b, _, _, a, c = dims
        units = b * a * (h * w // vec) * -(-c // chunk)
        assert blocks == min(SMS * resident, -(-units // focal_cuda.SUM_THREADS))
        assert busiest(dims, vec, chunk, wave) == least_busiest(dims, vec, wave)
        if units >= wave:
            assert blocks == SMS * resident


def test_dx_plan_at_p3_batch_8():
    """The dx kernel at P3, batch 8, on the blocks an H100 holds of it (5 at
    V = 4 f32, 48 registers; 4 at V = 8 bf16, 64 registers): f32 unsplit in
    one wave of 660 blocks, 1.86 units a thread (busiest 164 classes against
    180 in chunks of 16); bf16 in chunks of 16 on 528 blocks, 5.8 units a
    thread (108 against 164 unsplit)."""
    dims, strides, itemsize = level(104, 168, torch.float32, "view")
    assert focal_cuda.dx_vector(dims, strides, itemsize, 0, 512) == 4
    assert focal_cuda.sum_plan(dims, 4, SMS, 5) == (80, SMS * 5)
    assert busiest(dims, 4, 80, SMS * 5 * 256) == 164
    assert busiest(dims, 4, 16, SMS * 5 * 256) == 180
    assert focal_cuda.dx_vector(dims, strides, 2, 0, 512) == 8
    assert focal_cuda.sum_plan(dims, 8, SMS, 4) == (16, SMS * 4)
    assert busiest(dims, 8, 16, SMS * 4 * 256) == 108
    assert busiest(dims, 8, 80, SMS * 4 * 256) == 164


@pytest.mark.parametrize("name", sorted(probe_focal_parts.DX_CUTS))
def test_parts_probe_finds_its_dx_lines_in_the_kernel_source(name):
    """The dx probe's cuts replace whole lines of the kernel's source, each
    there exactly once."""
    source = focal_cuda.LIBRARY.source.read_text()
    pairs = probe_focal_parts.DX_CUTS[name]
    assert pairs
    for old, new in pairs:
        assert source.count(old) == 1 and old != new


def test_probe_keeps_the_old_dx_split_rule():
    """The probe's copy of the tiled dx kernel's channel split, for a
    --baseline source of that interface: P3 unsplit, the smaller levels split
    over blockIdx.z, a unit channel stride never."""
    sizes = [(104, 168), (52, 84), (26, 42), (13, 21), (7, 11)]
    assert [probe_focal_parts.old_split((8, h, w, 9, 80), h * w) for h, w in sizes] == \
        [1, 4, 15, 44, 90]
    assert all(probe_focal_parts.old_split((8, h, w, 9, 80), 1) == 1 for h, w in sizes)


@pytest.mark.parametrize("name", sorted(probe_focal_parts.CUTS))
def test_parts_probe_finds_its_lines_in_the_kernel_source(name):
    """The probe of the sum kernel's parts replaces whole lines of the
    kernel's source: each must be there exactly once."""
    source = focal_cuda.LIBRARY.source.read_text()
    pairs = probe_focal_parts.CUTS[name]
    assert pairs
    for old, new in pairs:
        assert source.count(old) == 1 and old != new


def test_parts_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe_focal_parts.main() == 1
