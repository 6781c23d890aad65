"""tide_attention's split plan, and its plain split-then-combine version,
against the JAX package's.

The CUDA kernel cuts each row's live range into S slices of R-position tiles
and merges the slices' partial softmax states in a second pass.
``tide_attention_split_ref`` does the same in plain PyTorch (fp32); here it
is held against the Pallas kernel in interpret mode and the JAX oracle at
1e-5, over the split counts and edges the kernel meets: empty slices,
``first_live`` and window edges inside a tile and on a tile edge, ``seq_len``
beyond the arena, and rows with no live position, which must give exactly 0.
``split_plan`` is checked at the two decode shapes that use the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tide_attention.kernel import \
    tide_attention as jax_tide_attention
from repro.kernels.tide_attention.ref import \
    tide_attention_ref as jax_tide_attention_ref
from repro_torch.kernels.tide_attention import kernel as tide_kernel
from repro_torch.kernels.tide_attention.ref import (split_bounds,
                                                    tide_attention_ref,
                                                    tide_attention_split_ref)
from test_torch_kernels_cuda import _tide_case

H100_SMS = 132


def _outputs(case, window, S, R):
    """(Pallas interpret, JAX oracle, plain, split) as float32 numpy."""
    jargs = [jnp.asarray(a) for a in case]
    targs = [torch.from_numpy(a) for a in case]
    pallas = jax_tide_attention(*jargs, window=window, interpret=True)
    oracle = jax_tide_attention_ref(*jargs, window=window)
    plain = tide_attention_ref(*targs, window=window)
    split = tide_attention_split_ref(*targs, window=window, S=S, R=R)
    return (np.asarray(pallas), np.asarray(oracle), plain.numpy(),
            split.numpy())


def _live_rows(case, window):
    """Rows with at least one live position."""
    _, ak, _, _, lens, live = case
    n_pos = ak.shape[1] * ak.shape[2]
    lo = np.maximum(live, 0)
    if window > 0:
        lo = np.maximum(lo, lens - window)
    return lo < np.minimum(lens, n_pos)


# (window, seq_lens, first_live) over 6 blocks of 32 positions, tiles of 16.
EDGES = {
    # first_live inside a tile (37), on a tile edge (32), and 0.
    "first_live": (0, [150, 96, 191], [37, 32, 0]),
    # seq_len - window inside a tile: lo = 105, 88, 60.
    "window_inside": (45, [150, 133, 70], [0, 16, 60]),
    # seq_len - window on a tile edge: lo = 96, 128, and first_live 48.
    "window_edge": (64, [160, 192, 100], [0, 0, 48]),
    # seq_len beyond the arena's 192 positions.
    "past_arena": (0, [300, 500, 10], [20, 0, 0]),
}


@pytest.mark.parametrize("S", [1, 2, 5, 33])
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_split_matches_jax(edge, S):
    window, lens, live = EDGES[edge]
    case = _tide_case(len(edge) * 7 + S, 3, 8, 2, 32, 32, 6, 32, lens, live)
    pallas, oracle, plain, split = _outputs(case, window, S, 16)
    np.testing.assert_allclose(split, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(split, oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(split, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,R", [(5, 16), (33, 16), (33, 32)])
def test_empty_slices_and_rows(S, R):
    """Rows of a tile or two leave most of 33 slices empty; rows with no
    live position (seq_len = 0, and everything below first_live) leave all
    of them empty and give exactly 0."""
    lens, live = [0, 20, 40, 3, 191], [0, 32, 17, 0, 0]
    case = _tide_case(41 + S, 5, 4, 1, 32, 32, 6, 32, lens, live)
    first, end = split_bounds(torch.tensor(lens), torch.tensor(live), 192, 0,
                              S, R)
    assert bool((first == end).any())
    pallas, oracle, plain, split = _outputs(case, 0, S, R)
    rows = _live_rows(case, 0)
    assert list(rows) == [False, False, True, True, True]
    assert not split[~rows].any()
    np.testing.assert_allclose(split[rows], pallas[rows], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(split[rows], oracle[rows], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(split[~rows], plain[~rows])


@pytest.mark.parametrize("window", [0, 45])
@pytest.mark.parametrize("S,R", [(1, 16), (3, 16), (7, 32), (40, 16)])
def test_split_bounds_cover_the_live_range(S, R, window):
    """The slices tile the R-aligned live range in order, without gaps or
    overlaps, and differ in length by at most one tile."""
    lens = torch.tensor([150, 0, 20, 191, 500])
    live = torch.tensor([37, 0, 32, 16, 0])
    n_pos = 192
    first, end = split_bounds(lens, live, n_pos, window, S, R)
    lo = live.clamp(min=0)
    if window:
        lo = torch.maximum(lo, lens - window)
    hi = lens.clamp(max=n_pos)
    for b in range(len(lens)):
        f, e = first[b].tolist(), end[b].tolist()
        assert all(x % R == 0 for x in f + e)
        assert f[1:] == e[:-1]
        sizes = [(y - x) // R for x, y in zip(f, e)]
        assert max(sizes) - min(sizes) <= 1
        if lo[b] < hi[b]:
            assert f[0] == lo[b] // R * R and e[-1] == -(-hi[b] // R) * R
        else:
            assert sum(sizes) == 0


def _row_bytes(d, dtype):
    return tide_kernel.row_bytes(d, d, dtype.itemsize)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    (8, 32, 8, 16, 128, 0, 128),      # Llama-3-8B decode: B H KH NB blk w d
    (4, 16, 1, 32, 128, 2048, 256),   # RecurrentGemma-9B decode
])
def test_split_plan_fills_the_card(shape, dtype):
    B, H, KH, NB, blk, window, d = shape
    S, R = tide_kernel.split_plan(B, H, KH, NB, blk, window, H100_SMS,
                                  _row_bytes(d, dtype))
    assert blk % R == 0
    assert S * KH * B >= H100_SMS
    tiles = -(-NB * blk // R)
    if window:
        tiles = min(tiles, -(-window // R) + 1)
    assert 1 <= S <= min(tiles, tide_kernel.MAX_SPLITS)
    assert 2 * R * _row_bytes(d, dtype) <= tide_kernel.STAGE_BUDGET


def test_split_plan_at_the_main_shapes():
    """The plans the chip check reports: 4 splits of 64-position tiles at
    Llama-3-8B, 33 at RecurrentGemma-9B (32 tiles of a 2048 window, one
    more when the window starts inside a tile)."""
    assert tide_kernel.split_plan(8, 32, 8, 16, 128, 0, H100_SMS,
                                  _row_bytes(128, torch.bfloat16)) == (4, 64)
    assert tide_kernel.split_plan(4, 16, 1, 32, 128, 2048, H100_SMS,
                                  _row_bytes(256, torch.bfloat16)) == (33, 64)
    # fp32 at d = 256: two 64-row stages would not fit, so tiles of 32.
    assert tide_kernel.split_plan(4, 16, 1, 32, 128, 2048, H100_SMS,
                                  _row_bytes(256, torch.float32))[1] == 32


@pytest.mark.parametrize("blk,R", [(128, 64), (64, 64), (256, 64)])
def test_split_plan_tile_divides_the_block(blk, R):
    """At block sizes that are multiples of 64 (the main shapes' 128) the
    tile divides the block, so every tile lies in one KV block and takes
    the kernel's single-block cursor."""
    S, got = tide_kernel.split_plan(2, 8, 2, 4, blk, 0, H100_SMS,
                                    _row_bytes(64, torch.bfloat16))
    assert got == R and blk % got == 0
    assert 1 <= S <= 4 * blk // R


@pytest.mark.parametrize("blk,R", [(96, 64), (48, 64), (24, 64), (8, 64)])
def test_split_plan_tile_comes_from_shared_memory_alone(blk, R):
    """The tile does not depend on the block size: where blk is smaller
    than R or R does not divide it, a tile spans several KV blocks
    (ROADMAP C.8), and the tiles still cover the whole arena."""
    S, got = tide_kernel.split_plan(2, 8, 2, 4, blk, 0, H100_SMS,
                                    _row_bytes(64, torch.bfloat16))
    assert got == R and blk % got != 0
    assert 1 <= S <= -(-4 * blk // R)


def test_split_plan_refuses_blocks_it_cannot_tile():
    """What it cannot tile: rows whose two stages of 16 positions overflow
    the shared-memory budget, and empty blocks.  Blocks of 8 positions
    plan."""
    with pytest.raises(ValueError, match="shared memory"):
        tide_kernel.split_plan(2, 8, 2, 4, 8, 0, H100_SMS,
                               tide_kernel.STAGE_BUDGET // 16)
    with pytest.raises(ValueError, match="shared memory"):
        tide_kernel.split_plan(2, 8, 2, 4, 0, 0, H100_SMS,
                               _row_bytes(64, torch.bfloat16))
    assert tide_kernel.split_plan(2, 4, 1, 8, 8, 16, H100_SMS,
                                  _row_bytes(16, torch.bfloat16)) == (1, 64)


def test_split_plan_grows_with_fewer_ctas():
    """Fewer CTAs a split (fewer rows or kv-heads) give more splits, up to
    the row's tiles; more query heads than 16 a kv-head count twice."""
    row = _row_bytes(128, torch.bfloat16)
    plan = lambda B, H, KH: tide_kernel.split_plan(B, H, KH, 64, 128, 0,
                                                   H100_SMS, row)[0]
    assert plan(1, 8, 8) > plan(8, 64, 8) > plan(64, 64, 8)
    assert plan(4, 32, 1) * 2 == plan(4, 16, 1)
    assert plan(1, 1, 1) == min(tide_kernel.MAX_SPLITS, 64 * 128 // 64)
