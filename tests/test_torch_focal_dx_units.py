"""The unit walk of the focal gradient kernel (``focal_dx_kernel`` in
``ioudet_torch/csrc/focal_kernel.cu``), replayed in torch on the CPU and held
against the plain version ``focal_level_dx_plain``.  The kernel cannot run
here; the replay is its algorithm step for step, kept here and not in the
package:

  * unit u = ((b * A + a) * chunks + k) * runs + r owns positions
    r * V ... r * V + V - 1 of image b, anchor a and classes k * chunk up to
    min(C, (k + 1) * chunk); position v of the run is element x0 + v of its
    channel plane when V > 1 (the positions are the plane's unit-stride axis)
    and at the position's own strides when V = 1;
  * the class loop writes every element of the unit with the background
    form (t = 0) times g and the position's weight;
  * after the loop, each position whose target class lies in the chunk has
    that one element written again by the general chain at t = 1.

On the small shapes of ``chip_smoke.FOCAL_SHAPES`` (edges included, on
their edge data), at every run length V the planner can give for the shape
and at chunks of 8 up to C: the result equals the plain version (rtol 1e-5 /
atol 1e-6), the loop writes every element of the logits' view exactly once
and nothing else, and without the patch the result differs from it at
exactly the target elements whose weight is not 0.  Imports no JAX.
"""

import pytest
import torch

import chip_smoke
from ioudet_torch.ops import focal_cuda
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

GAMMA, ALPHA, G = 2.0, 0.25, 3.0
SMALL = [s for s in chip_smoke.FOCAL_SHAPES if s[0] * s[1] * s[2] * s[3] * s[4] <= 200_000]
# (shape, layout, V): the permuted NCHW view at every V in 1, 2, 4, 8 that
# divides H*W (8 only in bf16), contiguous logits at V = 1
CASES = [(s, "view", v) for s in SMALL for v in (1, 2, 4, 8) if (s[1] * s[2]) % v == 0]
CASES += [(s, "contiguous", 1) for s in SMALL]


def level(shape, layout):
    """f32 logits (the view or contiguous), labels and weights as the slices
    chip_smoke.phase_focal_kernels takes."""
    b, h, w, a, c = shape
    n = h * w * a
    case = chip_smoke.focal_edge_case if shape in chip_smoke.FOCAL_EDGES else chip_smoke.focal_case
    nchw, labels, lw = case(shape, seed=h)
    x = torch.from_numpy(nchw).permute(0, 2, 3, 1)
    if layout == "contiguous":
        x = x.contiguous()
    return x, torch.from_numpy(labels)[:, 5:5 + n], torch.from_numpy(lw)[:, 5:5 + n]


def replay(x, labels, lw, g, a, vec, chunk, patch=True):
    """(dx with x's strides, writes of the class loop per element of the
    storage) by the kernel's walk over every unit."""
    b, h, w, ac = x.shape
    c = ac // a
    sb, sh, sw, sc = x.stride()
    span = 1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride()))
    src = x.as_strided((span,), (1,))
    runs, chunks = h * w // vec, -(-c // chunk)
    u = torch.arange(b * a * chunks * runs)
    r, q = u % runs, u // runs
    k, ba = q % chunks, q // chunks
    an, bi = ba % a, ba // a
    hw0 = r * vec
    pos = hw0 if vec > 1 else (hw0 // w) * sh + (hw0 % w) * sw
    c0 = k * chunk
    c1 = torch.clamp(c0 + chunk, max=c)
    x0 = bi * sb + pos + an * c * sc                       # class 0 of the unit's anchor
    v = torch.arange(vec)
    n = (hw0 * a + an)[:, None] + v * a                    # (unit, v): the (position, anchor)
    lab, wt = labels[bi[:, None], n], lw[bi[:, None], n]
    # the class loop: (unit, v, class of the chunk), the chunk's ragged end masked
    cls = c0[:, None] + torch.arange(chunk)
    live = (cls < c1[:, None])[:, None, :].expand(-1, vec, -1)
    off = (x0[:, None, None] + cls[:, None, :] * sc + v[None, :, None])[live]
    xv = src[off]
    _, bg = focal_cuda._focal_terms(xv, torch.zeros_like(xv), GAMMA, ALPHA)
    out = torch.full((span,), float("nan"))
    out[off] = g * bg * wt[:, :, None].expand(-1, -1, chunk)[live]
    writes = torch.bincount(off, minlength=span)
    if patch:   # each position's target in the chunk, by the general chain at t = 1
        hit = (lab > c0[:, None]) & (lab <= c1[:, None])
        poff = (x0[:, None] + (lab - 1) * sc + v)[hit]
        _, fg = focal_cuda._focal_terms(src[poff], torch.ones(poff.shape), GAMMA, ALPHA)
        out[poff] = g * fg * wt[hit]
    return out.as_strided(x.shape, x.stride()), writes


def chunks_of(c):
    return sorted({min(c, 8), c, *range(8, c + 1, 8)})


@pytest.mark.parametrize("shape, layout, vec", CASES, ids=[f"{s}-{l}-V{v}" for s, l, v in CASES])
def test_replay_of_the_unit_walk_equals_plain(shape, layout, vec):
    x, labels, lw = level(shape, layout)
    a = shape[3]
    g = torch.tensor(G)
    want = focal_cuda.focal_level_dx_plain(g, x, labels, lw, GAMMA, ALPHA, a)
    b, h, w, _, c = shape
    target = (labels.reshape(b, h, w, a, 1) - 1 == torch.arange(c)).reshape(x.shape)
    weighted = (lw != 0).reshape(b, h, w, a, 1).expand(-1, -1, -1, -1, c).reshape(x.shape)
    for chunk in chunks_of(c):
        got, writes = replay(x, labels, lw, g, a, vec, chunk)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        assert int(writes.sum()) == x.numel()
        assert bool((writes.as_strided(x.shape, x.stride()) == 1).all())
        unpatched, _ = replay(x, labels, lw, g, a, vec, chunk, patch=False)
        assert torch.equal(unpatched != got, target & weighted)


def test_cases_cover_every_run_length_the_planner_gives():
    """Every V that dx_vector gives on these shapes, for logits and dx bases
    on the grid of 16 bytes or off it, f32 and bf16, is replayed."""
    for shape in SMALL:
        b, h, w, a, c = shape
        strides = (a * c * h * w, w, 1, h * w)
        for itemsize in (4, 2):
            for dx_address in (0, 2, 4, 8):
                vec = focal_cuda.dx_vector(shape, strides, itemsize, 0, dx_address)
                assert (shape, "view", vec) in CASES
