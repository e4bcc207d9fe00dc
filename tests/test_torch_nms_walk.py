"""The NMS kernels' algorithms (``ioudet_torch/csrc/nms_kernel.cu``),
replayed on the CPU and held bit for bit against the plain versions
``nms_mask_plain`` and ``nms_reduce_plain``.  The kernels cannot run here;
the replays are their algorithms step for step, kept here and not in the
package:

  * K1b (``nms_reduce_kernel``): removed[] starts as the invalid rows; the
    tiles (row block c, a window of ``win`` words starting at c rounded down
    to the copy's width ``vec``, then ``win`` words further on) are staged as
    slabs in order; on the first window of a block the walker jumps from
    candidate to candidate (cand = ~removed[c]), rows 0-31 first, then rows
    32-63 less what the kept rows 0-31 removed there; then the kept rows are
    ORed into the later words of the window, eight rows to a group; keep =
    ~removed at the end.  The replay takes three faults, an OR that stops
    one word short of the window's edge, a candidate set that ignores
    ``valid`` and a walk of rows 32-63 that forgets rows 0-31, and the tests
    check that each of them is caught.
  * K1a (``nms_mask_kernel``): the triangular tile index covers each tile
    on and above the diagonal exactly once, and the tiles' stores (words of
    four column blocks, the diagonal tile's run from word 0) write every
    word of the mask exactly once, to the plain mask's value; its test
    without the division (inter > mid * denom in double) equals the f32
    quotient against the threshold on pairs that straddle it.

Also the lines the parts probe replaces.  Imports no JAX.
"""

import functools
import math
import re

import numpy as np
import pytest
import torch

import chip_smoke
from ioudet_torch.core.bbox.geometry import bbox_overlaps
from ioudet_torch.ops import nms_cuda
from ioudet_torch.tools import probe_nms_parts as P
from tests.torch_twins import one_thread  # noqa: F401 (autouse)

FULL = (1 << 64) - 1
HALF = (1 << 32) - 1
# column blocks of a mask tile, as the kernel's source sets them
TILE_COLS = int(re.search(r"constexpr int kTileCols = (\d+);",
                          nms_cuda.LIBRARY.source.read_text()).group(1))


def cases(n, batch=2, seed=None):
    seed = n if seed is None else seed
    return chip_smoke.nms_cases(n, batch, seed) + chip_smoke.nms_edge_cases(n, batch, seed)


@functools.lru_cache(maxsize=None)
def plain_cases(n):
    """(name, mask words, valid, the plain keep) of every case at N = n."""
    out = []
    for name, b, v in cases(n):
        tv = torch.from_numpy(v)
        mask = nms_cuda.nms_mask_plain(torch.from_numpy(b), 0.5)
        out.append((name, mask, tv, nms_cuda.nms_reduce_plain(mask, tv)))
    return out


def walk_half(cand, words):
    """One half of the walker: the candidates lowest row first (the kernel
    holds them bit-reversed, so that its next one is the highest set bit),
    each kept row's word over the half removing its later candidates."""
    kept = 0
    while cand:
        j = (cand & -cand).bit_length() - 1
        kept |= 1 << j
        cand = cand & (cand - 1) & ~words[j]
    return kept


def replay_reduce(mask, valid, win, vec, short_window=False, ignore_valid=False,
                  no_half_carry=False):
    """K1b's walk: mask (B, N, W) int64, valid (B, N) -> keep (B, N)."""
    b, n, w = mask.shape
    keep = []
    for img in range(b):
        rows = [[x & FULL for x in r] for r in mask[img].tolist()]
        live = [bool(x) or ignore_valid for x in valid[img].tolist()]
        removed = []
        for word in range(w):
            bits = sum(1 << j for j in range(64) if 64 * word + j < n and live[64 * word + j])
            removed.append(~bits & FULL)
        c, w0 = 0, 0
        while c < w:
            w1 = min(w0 + win, w)
            slab = [r[w0:w1] for r in rows[64 * c:64 * c + 64]]
            if w0 == c - c % vec:
                live = ~removed[c] & FULL
                diag = [r[c - w0] for r in slab] + [0] * (64 - len(slab))
                lo = walk_half(live & HALF, [d & HALF for d in diag[:32]])
                sup = 0
                for j in range(32):
                    if lo >> j & 1 and not no_half_carry:
                        sup |= diag[j] >> 32
                hi = walk_half(live >> 32 & ~sup, [d >> 32 for d in diag[32:]])
                removed[c] = ~(hi << 32 | lo) & FULL
            kept = ~removed[c] & FULL
            for word in range(max(c + 1, w0), w1 - (1 if short_window else 0)):
                for g in range(8):
                    acc = 0
                    for r in range(8 * g, 8 * g + 8):
                        if kept >> r & 1:
                            acc |= slab[r][word - w0]
                    removed[word] |= acc
            w0 += win
            if w0 >= w:
                c += 1
                w0 = c - c % vec
        keep.append([not removed[i // 64] >> (i % 64) & 1 for i in range(n)])
    return torch.tensor(keep, dtype=torch.bool)


def windows(n):
    """(win, vec) of the replays at N: windows of 1 and 2 words, and one as
    wide as the mask; 16-byte copies (vec 2) where W is even, as the kernel."""
    w = nms_cuda.num_words(n)
    vec = 2 if w % 2 == 0 else 1
    return [(1, 1), (2, 1), (2, vec), (w + w % 2, vec)]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 200])
@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_walk_replay_equals_plain(n, which):
    win, vec = windows(n)[which]
    for name, mask, tv, want in plain_cases(n):
        assert torch.equal(replay_reduce(mask, tv, win, vec), want), (name, win, vec)


@pytest.mark.parametrize("fault", ["short_window", "ignore_valid", "no_half_carry"])
def test_walk_replay_catches_its_faults(fault):
    """The replay is only worth its agreement if it can disagree: an OR one
    word short of the window's edge, candidates taken from every row, or a
    walk of rows 32-63 that forgets what the kept rows 0-31 removed there,
    give another keep mask on some case."""
    n = 200
    caught = []
    for win, vec in windows(n):
        for name, mask, tv, want in plain_cases(n):
            got = replay_reduce(mask, tv, win, vec, **{fault: True})
            caught.append(not torch.equal(got, want))
    assert any(caught)


def test_edge_cases_keep_what_they_say():
    """Disjoint boxes keep every valid box, invalid ones keep none, equal
    boxes keep the first; the class-offset candidates keep some and drop
    some."""
    for name, b, v in chip_smoke.nms_edge_cases(130, 2, seed=3):
        keep = nms_cuda.greedy_keep(torch.from_numpy(b), torch.from_numpy(v), 0.5)
        if name == "disjoint":
            assert keep.all()
        elif name == "all_invalid":
            assert not keep.any()
        elif name == "first_suppresses_all":
            assert keep[:, 0].all() and not keep[:, 1:].any()
        else:
            assert 0 < int(keep.sum()) < int(torch.from_numpy(v).sum())


# ------------------------------------------------------------------ K1a

def tile_of(t, tiles, cols=TILE_COLS):
    """nms_mask_kernel's tile_of on numpy arrays of tile indices, for tiles
    of ``cols`` column blocks (kTileCols)."""
    t = np.asarray(t, dtype=np.int64)
    b = 2.0 * tiles + 1.0
    r = ((b - np.sqrt(np.maximum(b * b - 8.0 * t / cols, 0.0))) * 0.5).astype(np.int64)
    r = np.clip(r, 0, tiles - 1)

    def before(r):
        return cols * (r * tiles - r * (r - 1) // 2)

    while True:
        down = (r > 0) & (before(r) > t)
        up = (r + 1 < tiles) & (before(r + 1) <= t)
        if not (down.any() or up.any()):
            break
        r = r - down + up
    local = t - before(r)
    per = tiles - r
    return cols * r + local // per, r + local % per


def num_tiles(words, cols=TILE_COLS):
    """ioudet_nms_mask's grid size."""
    q = -(-words // cols)
    return cols * ((q - 1) * q - (q - 1) * (q - 2) // 2) + (words - cols * (q - 1))


@pytest.mark.parametrize("cols", [4, 8, 16])
@pytest.mark.parametrize("words", [1, 7, 8, 9, 32, 33, 188, 6080])
def test_tile_index_covers_the_upper_tiles_once(words, cols):
    """The grid has one block per (row block, column tile) on or above the
    diagonal, and tile_of maps the blocks onto them one to one (6080 words:
    the wrappers' MAX_N; tiles of the kernel's 4 column blocks, and the
    parts probe's 8 and 16)."""
    q = -(-words // cols)
    rb, oc = tile_of(np.arange(num_tiles(words, cols)), q, cols)
    assert (rb < words).all() and (oc < q).all() and (oc >= rb // cols).all()
    want = sum(q - r // cols for r in range(words))
    assert num_tiles(words, cols) == want
    assert len(np.unique(rb * q + oc)) == want
    assert nms_cuda.num_words(nms_cuda.MAX_N) == 6080


def replay_mask(boxes, thr):
    """K1a's tiles and stores: every word of (B, N, W) written once."""
    b, n, _ = boxes.shape
    w = nms_cuda.num_words(n)
    q = -(-w // TILE_COLS)
    supp = bbox_overlaps(boxes, boxes) > thr
    out = torch.zeros(b, n, w, dtype=torch.int64)
    writes = torch.zeros(b, n, w, dtype=torch.int64)
    weights = nms_cuda._bit_weights("cpu")
    rbs, ocs = tile_of(np.arange(num_tiles(w)), q)
    for rb, oc in zip(rbs.tolist(), ocs.tolist()):
        rows = slice(64 * rb, min(64 * rb + 64, n))
        wfirst, wend = TILE_COLS * oc, min(TILE_COLS * oc + TILE_COLS, w)
        wstart = 0 if oc == rb // TILE_COLS else wfirst
        for word in range(wstart, wend):
            if word < max(wfirst, rb):
                val = torch.zeros(rows.stop - rows.start, dtype=torch.int64)
            else:
                cols = torch.arange(64 * word, 64 * word + 64)
                bits = torch.zeros(b, rows.stop - rows.start, 64, dtype=torch.bool)
                inside = cols < n
                bits[..., inside] = supp[:, rows, cols[inside]]
                if word == rb:
                    i = torch.arange(rows.start, rows.stop)
                    bits &= cols[None, None, :] > i[None, :, None]
                val = (bits.long() * weights).sum(-1)
            out[:, rows, word] = val
            writes[:, rows, word] += 1
    return out, writes


@pytest.mark.parametrize("n", [1, 65, 600, 1100])
def test_mask_tiles_write_every_word_once(n):
    for name, b, _ in cases(n, batch=1)[:3] + cases(n, batch=1)[-1:]:
        tb = torch.from_numpy(b)
        got, writes = replay_mask(tb, 0.5)
        assert bool((writes == 1).all()), name
        assert torch.equal(got, nms_cuda.nms_mask_plain(tb, 0.5)), name


def division_free_above(inter, denom, thr):
    """nms_mask_kernel's test without the division, in numpy: inter > mid *
    denom in double, mid halfway between the f32 thr and the next float up."""
    t = np.float32(thr)
    mid = 0.5 * (np.float64(t) + np.float64(np.nextafter(t, np.float32(np.inf))))
    return inter.astype(np.float64) > mid * denom.astype(np.float64)


@pytest.mark.parametrize("thr", [0.5, 0.3, 0.45, 0.7, 0.0, 0.999, 1e-3])
def test_division_free_test_equals_the_f32_quotient(thr):
    """fl32(inter / denom) > thr, as bbox_overlaps and the plain mask decide
    it, equals the kernel's double-precision rule on pairs that straddle the
    threshold: inter within 3 ulp of mid * denom, denominators from 1e-10 (the
    floor) to box areas of 1e8, and on random pairs."""
    rng = np.random.default_rng(int(thr * 1e3))
    t = np.float32(thr)
    mid = 0.5 * (np.float64(t) + np.float64(np.nextafter(t, np.float32(np.inf))))
    denom = np.concatenate([10.0 ** rng.uniform(-10, 8, 20000),
                            rng.integers(1, 4000, 20000) ** 2.0]).astype(np.float32)
    inter = (mid * denom.astype(np.float64)).astype(np.float32)
    inter = np.concatenate([inter] + [np.nextafter(inter, np.float32(s * np.inf))
                                      for s in (-1, 1)])
    inter = np.concatenate([inter, np.nextafter(inter, np.float32(np.inf)),
                            np.nextafter(inter, np.float32(-np.inf)),
                            (rng.uniform(size=inter.size) * np.tile(denom, 3)).astype(np.float32)])
    denom = np.tile(denom, 12)
    inter = np.maximum(inter, np.float32(0.0))
    want = (torch.from_numpy(inter) / torch.from_numpy(denom) > float(t)).numpy()
    got = division_free_above(inter, denom, thr)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)


# ----------------------------------------------------------- parts probe

@pytest.mark.parametrize("name", sorted(P.CUTS))
def test_parts_probe_finds_its_lines_in_the_kernel_source(name):
    """The probe of the kernels' parts replaces whole lines of the source:
    each must be there exactly once, or its copy would time the whole
    kernels under a cut's name."""
    source = nms_cuda.LIBRARY.source.read_text()
    for old, new in P.CUTS[name]:
        assert source.count(old) == 1, old
        assert old != new


def test_parts_probe_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.main([]) == 1


def test_chain_floor_counts_the_dependent_steps():
    """K1b's chain floor: the kept rows of the longest image plus one barrier
    a row block, times the per-step latency."""
    keep = torch.zeros(3, 130, dtype=torch.bool)
    keep[1, :70] = True
    keep[2, :5] = True
    assert P.chain_steps(keep) == 70 + 3
    assert math.isclose(P.chain_floor_ms(keep, 20e-6), 73 * 20e-6)
