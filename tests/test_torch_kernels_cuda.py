"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

The Bloom probe and the lookup are integer, so kernel and plain version
must be equal; tide_attention is held at the tolerances of the JAX
package's ``TestTideAttention`` (2e-5 in fp32, 2e-2 in bf16); ssd_scan at
``TestSsdScan``'s 3e-4 in fp32 and, in bf16, by its mean error against the
plain version run in fp32, which may exceed the plain version's own bf16
mean error by at most a quarter.  The input builders here are shared with
``test_torch_kernels.py``, ``test_torch_attention.py`` and
``test_torch_ssm.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bloom_check import kernel as bloom_kernel
from repro_torch.kernels.bloom_check import ops as bloom_ops
from repro_torch.kernels.bloom_check.ref import (bloom_check_ragged_ref,
                                                 bloom_check_ref)
from repro_torch.kernels.optimistic_lookup import kernel as lookup_kernel
from repro_torch.kernels.optimistic_lookup import ops as lookup_ops
from repro_torch.kernels.optimistic_lookup.ref import (
    lookup_indices_ref, optimistic_lookup_ref, optimistic_lookup_search)
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan.ops import ssd
from repro_torch.kernels.ssd_scan.ref import ssd_scan as ssd_scan_ref
from repro_torch.kernels.ssd_scan.ref import ssd_scan_passes
from repro_torch.kernels.tide_attention import kernel as tide_kernel
from repro_torch.kernels.tide_attention.ops import decode_attention
from repro_torch.kernels.tide_attention.ref import tide_attention_ref


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bloom_bits(h1, h2, nbits, nwords, k):
    """A bitset with the given hashes added: numpy u32 arithmetic."""
    bits = np.zeros(nwords, np.uint32)
    for i in range(k):
        idx = (h1 + np.uint32(i) * h2) % np.uint32(nbits)
        np.bitwise_or.at(bits, (idx >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (idx & np.uint32(31)))
    return bits


def _hashes(rng, n):
    return (rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32) | np.uint32(1))


def _wraps(h1, h2, nbits, k):
    """True if skipping the 2³² wrap would change some probe index."""
    a, b = h1.astype(np.int64), h2.astype(np.int64)
    return any(np.any(((a + i * b) % nbits) != (((a + i * b) & 0xFFFFFFFF)
                                                  % nbits))
               for i in range(k))


def _ragged_case(seed, nwords_list, nadd_list, nbits_list, n_miss, k=7):
    """Packed cells with their own moduli, plus queries for each: the added
    keys, then random misses."""
    rng = np.random.default_rng(seed)
    h1, h2, off, nb, words = [], [], [], [], []
    base = 0
    for nwords, nadd, nbits in zip(nwords_list, nadd_list, nbits_list):
        nbits = nbits or nwords * 32
        h1a, h2a = _hashes(rng, nadd)
        words.append(_bloom_bits(h1a, h2a, nbits, nwords, k))
        h1m, h2m = _hashes(rng, n_miss)
        h1 += [h1a, h1m]
        h2 += [h2a, h2m]
        off.append(np.full(nadd + n_miss, base, np.int32))
        nb.append(np.full(nadd + n_miss, nbits, np.uint32))
        base += nwords
    return (np.concatenate(h1), np.concatenate(h2), np.concatenate(off),
            np.concatenate(nb), np.concatenate(words))


def _lookup_case(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        # Clustered keys break the uniformity assumption: with a budget of
        # two rounds some queries stay unresolved and take the oracle.
        keys = np.unique(np.concatenate([
            rng.integers(0, 2**32, 5000, dtype=np.uint32),
            np.arange(2**31, 2**31 + 4096, dtype=np.uint32)]))
        queries = np.concatenate([keys[:64], keys[-40:],
                                  np.arange(2**31, 2**31 + 4096, 64,
                                            dtype=np.uint32)])
    elif kind == "edges":
        # Keys inside [2^24, 2^31): queries below the first key, above the
        # last and at both ends of the u32 range.
        keys = np.unique(rng.integers(2**24, 2**31, 3000, dtype=np.uint32))
        queries = np.concatenate([
            rng.choice(keys, 32),
            np.uint32([keys[0] - 1, keys[0] // 2, keys[-1] + 1,
                       (int(keys[-1]) + 2**32) // 2])])
    elif kind == "all_equal":
        v = np.uint32(rng.integers(1, 2**32 - 1))
        keys = np.full(3000, v, np.uint32)
        queries = np.concatenate([np.uint32([v, v - 1, v + 1] * 4),
                                  rng.integers(0, 2**32, 16,
                                               dtype=np.uint32)])
    elif kind == "equal_prefix":
        # Runs of equal u32 prefixes, as colliding key prefixes give.
        base = np.unique(rng.integers(0, 2**32, 900, dtype=np.uint32))
        keys = np.sort(np.repeat(base, rng.integers(1, 6, len(base))))
        queries = np.concatenate([rng.choice(base, 96),
                                  rng.integers(0, 2**32, 32,
                                               dtype=np.uint32)])
    else:
        keys = np.unique(rng.integers(0, 2**32, kind, dtype=np.uint32))
        queries = np.concatenate([rng.choice(keys, 64),
                                  rng.integers(0, 2**32, 64,
                                               dtype=np.uint32)])
    edges = np.uint32([0, 1, 0xFFFFFFFF, 0xFFFFFFFE, keys[0], keys[-1]])
    return keys.astype(np.uint32), np.concatenate([queries,
                                                   edges]).astype(np.uint32)


# The lookup's cases, (keys, window, max_iters): the seven of the JAX
# comparison; windows about the 32 lanes and about the one-load segment,
# which holds ceil((W-1)/31) - 1 keys, at most 32 up to W = 1024; N < W; no
# rounds at all; queries at and beyond both ends; every key equal.
LOOKUP_CASES = [
    (1000, 128, 4), (20000, 512, 4), (50000, 2048, 4), (300, 512, 4),
    (4096, 800, 4), ("clustered", 128, 2), ("equal_prefix", 64, 4),
    (20000, 1, 4), (20000, 31, 4), (20000, 32, 4), (20000, 33, 4),
    (20000, 993, 4), (20000, 994, 4), (20000, 1024, 4), (20000, 1025, 4),
    (700, 993, 4), (20000, 512, 0), ("edges", 64, 4), ("edges", 800, 1),
    ("all_equal", 32, 4), ("all_equal", 800, 4),
]


def _tide_case(seed, B, H, KH, dk, dv, NB, blk, lens, live):
    """Decode-attention inputs as float32 numpy: q (B,H,dk), arenas
    (B,NB,blk,KH,d) of standard normals, a random permutation as each
    sequence's table, and the given lengths and watermarks."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, dk)).astype(np.float32)
    ak = rng.standard_normal((B, NB, blk, KH, dk)).astype(np.float32)
    av = rng.standard_normal((B, NB, blk, KH, dv)).astype(np.float32)
    table = np.stack([rng.permutation(NB) for _ in range(B)]).astype(np.int32)
    return (q, ak, av, table, np.asarray(lens, np.int32),
            np.asarray(live, np.int32))


def _ssd_case(seed, b, l, h, p, n, init=False):
    """SSD inputs as float32 numpy, drawn as ``TestSsdScan`` draws them:
    x, dt (after a softplus), A (negative), Bm, Cm and, with ``init``, an
    initial state (else None)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((b, l, h)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((b, h, p, n)) * 0.5).astype(np.float32) \
        if init else None
    return x, dt, A, Bm, Cm, s0


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nbits", [None, 1000])
def test_bloom_check_kernel_on_card(card, nbits):
    rng = np.random.default_rng(5)
    h1a, h2a = _hashes(rng, 600)
    bits = _bloom_bits(h1a, h2a, nbits or 64 * 32, 64, 7)
    h1m, h2m = _hashes(rng, 3000)
    h1 = _t(np.concatenate([h1a, h1m])).to(card)
    h2 = _t(np.concatenate([h2a, h2m])).to(card)
    b = _t(bits).to(card)
    before = bloom_kernel.launches["bloom_check"]
    got = bloom_ops.might_contain(h1, h2, b, nbits=nbits)
    torch.cuda.synchronize()
    assert bloom_kernel.launches["bloom_check"] == before + 1
    want = bloom_check_ref(h1, h2, b, nbits=nbits)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_bloom_check_ragged_kernel_on_card(card):
    h1, h2, off, nb, bits = _ragged_case(
        3, [2048] * 16 + [40], [1200] * 16 + [60], [None] * 16 + [1111], 900)
    args = [_t(a).to(card) for a in (h1, h2, off, nb, bits)]
    before = bloom_kernel.launches["bloom_check_ragged"]
    got = bloom_ops.probe_ragged(*args)
    torch.cuda.synchronize()
    assert bloom_kernel.launches["bloom_check_ragged"] == before + 1
    assert torch.equal(got, bloom_check_ragged_ref(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window,max_iters", [
    (200000, 800, 4), ("clustered", 128, 2), ("equal_prefix", 64, 4),
    (300, 512, 4)])
def test_optimistic_lookup_kernel_on_card(card, kind, window, max_iters):
    keys, queries = _lookup_case(kind, 3)
    q, k = _t(queries).to(card), _t(keys).to(card)
    before = lookup_kernel.launches["optimistic_lookup"]
    got = lookup_ops.lookup(q, k, window=window, max_iters=max_iters)
    torch.cuda.synchronize()
    assert lookup_kernel.launches["optimistic_lookup"] == before + 1
    want = optimistic_lookup_ref(q, k, window=window, max_iters=max_iters)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window,max_iters", [
    ("clustered", 128, 2), ("equal_prefix", 64, 4), (300, 512, 4)])
def test_lookup_indices_batch_on_card(card, kind, window, max_iters):
    """The numpy entry on the card, oracle fallback included, equals the
    same entry on the CPU."""
    keys, queries = _lookup_case(kind, 9)
    before = lookup_kernel.launches["optimistic_lookup_resolve"]
    got = lookup_ops.lookup_indices_batch(queries, keys, window=window,
                                          max_iters=max_iters, device="cuda")
    assert lookup_kernel.launches["optimistic_lookup_resolve"] == before + 1
    want = lookup_ops.lookup_indices_batch(queries, keys, window=window,
                                           max_iters=max_iters, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window,max_iters", LOOKUP_CASES)
def test_lookup_entries_on_card(card, kind, window, max_iters):
    """Both entries of the lookup kernel on every case of the CPU search
    test: the raw one equal to the TPU kernel's arithmetic and to the
    search mirror, the resolve one to the plain version with the oracle."""
    keys, queries = _lookup_case(kind, 11)
    q, k = _t(queries).to(card), _t(keys).to(card)
    kw = dict(window=window, max_iters=max_iters)
    before = dict(lookup_kernel.launches)
    got = lookup_kernel.optimistic_lookup(q, k, **kw)
    resolved = lookup_kernel.optimistic_lookup_resolve(q, k, **kw)
    torch.cuda.synchronize()
    for name in ("optimistic_lookup", "optimistic_lookup_resolve"):
        assert lookup_kernel.launches[name] == before[name] + 1, name
    for g, w, m in zip(got, optimistic_lookup_ref(q, k, **kw),
                       optimistic_lookup_search(q, k, **kw)):
        assert torch.equal(g, w) and torch.equal(g, m)
    for g, w in zip(resolved, lookup_indices_ref(q, k, **kw)):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,window,max_iters", LOOKUP_CASES)
def test_lookup_positions_on_card(card, kind, window, max_iters):
    """``lookup_positions`` on the card launches the resolve entry once and
    equals the plain version's positions on the CPU."""
    keys, queries = _lookup_case(kind, 13)
    pos = (np.arange(len(keys), dtype=np.uint32) * 40 + 7).astype(np.uint32)
    kw = dict(window=window, max_iters=max_iters)
    before = lookup_kernel.launches["optimistic_lookup_resolve"]
    got = lookup_ops.lookup_positions(_t(queries).to(card), _t(keys).to(card),
                                      _t(pos).to(card), **kw)
    torch.cuda.synchronize()
    assert lookup_kernel.launches["optimistic_lookup_resolve"] == before + 1
    want = lookup_ops.lookup_positions(_t(queries), _t(keys), _t(pos), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_lookup_indices_does_not_sync_on_card(card):
    """On CUDA tensors ``lookup_indices`` is one launch of the resolve
    entry: no host sync (which the sync debug mode turns into an error),
    even with unresolved queries."""
    keys, queries = _lookup_case("clustered", 9)
    q, k = _t(queries).to(card), _t(keys).to(card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        idx, found = lookup_ops.lookup_indices(q, k, window=128, max_iters=2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    raw = lookup_kernel.optimistic_lookup(q, k, window=128, max_iters=2)
    assert bool((raw[0] < 0).any())
    want = lookup_indices_ref(q, k, window=128, max_iters=2)
    assert torch.equal(idx, want[0]) and torch.equal(found, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 7, 8])
def test_bloom_kernels_every_k_on_card(card, k):
    """A and B gather all k words before testing a bit: every k of the
    unrolled group, moduli that are no power of two (the u32 wrap shows)."""
    h1, h2, off, nb, bits = _ragged_case(
        k, [64, 40, 100, 2], [300, 60, 500, 1], [2000, 1111, 3171, 37], 500,
        k=k)
    assert k == 1 or _wraps(h1, h2, nb.astype(np.int64), k)
    args = [_t(a).to(card) for a in (h1, h2, off, nb, bits)]
    got = bloom_kernel.bloom_check_ragged(*args, k=k)
    assert torch.equal(got, bloom_check_ragged_ref(*args, k=k))
    first = int(np.searchsorted(off, 64))        # the first cell's queries
    one = [a[:first] for a in args[:2]] + [args[4][:64]]
    got = bloom_kernel.bloom_check(*one, k=k, nbits=2000)
    assert torch.equal(got, bloom_check_ref(*one, k=k, nbits=2000))
    assert got[:300].all()                        # no false negatives


@pytest.mark.cuda
def test_probe_cells_batch_on_card(card):
    """The numpy entry of the fused probe on the card equals the CPU one."""
    h1, h2, off, nb, bits = _ragged_case(
        4, [64, 2, 1024, 40], [100, 0, 2000, 60], [None, None, None, 1111],
        77)
    before = bloom_kernel.launches["bloom_check_ragged"]
    got = bloom_ops.probe_cells_batch(h1, h2, off, nb, bits, device="cuda")
    assert bloom_kernel.launches["bloom_check_ragged"] == before + 1
    np.testing.assert_array_equal(
        got, bloom_ops.probe_cells_batch(h1, h2, off, nb, bits, device="cpu"))


def _tide_on_card(case, card, dtype):
    q, ak, av, table, lens, live = case
    return ([_t(a).to(card, dtype) for a in (q, ak, av)]
            + [_t(a).to(card) for a in (table, lens, live)])


def _tide_launch(args, window):
    """decode_attention through the kernel; checks that the split pass ran
    once and the combine pass once exactly when the plan splits."""
    S, _ = tide_kernel.plan(*args[:3], window)
    before = dict(tide_kernel.launches)
    got = decode_attention(*args, window=window)
    torch.cuda.synchronize()
    assert tide_kernel.launches["tide_attention"] == \
        before["tide_attention"] + 1
    assert tide_kernel.launches["tide_attention_combine"] == \
        before["tide_attention_combine"] + (S > 1)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,H,KH,dk,dv,NB,blk,window", [
    (8, 32, 8, 128, 128, 16, 128, 0),     # Llama-3-8B decode
    (8, 32, 8, 128, 128, 16, 128, 300),   # ... with a sliding window
    (4, 16, 1, 256, 256, 32, 128, 2048),  # RecurrentGemma-9B decode
    (2, 8, 4, 64, 64, 4, 32, 0),          # GQA
    (1, 4, 1, 128, 128, 3, 128, 0),       # MQA
    (1, 32, 1, 64, 64, 3, 32, 0),         # G = 32: two CTAs a kv-head
    (2, 8, 2, 96, 96, 3, 64, 0),          # phi3-mini's head dim of 96
    (3, 4, 4, 32, 32, 2, 16, 0),          # MHA
    (2, 16, 2, 64, 32, 5, 64, 48),        # dk != dv, window
    (2, 8, 2, 64, 64, 6, 8, 0),           # blk = 8 < R: tiles span blocks
    (3, 16, 4, 64, 32, 5, 24, 40),        # blk = 24: R does not divide it
    (2, 4, 1, 16, 16, 4, 8, 16),          # RecurrentGemma SMOKE decode
    (8, 16, 16, 128, 128, 16, 128, 0),    # Qwen2-MoE-A2.7B decode: G = 1
    (8, 20, 20, 64, 64, 4, 128, 0),       # whisper-large-v3 decoder: G = 1
])
def test_tide_attention_kernel_on_card(card, dtype, tol, B, H, KH, dk, dv,
                                       NB, blk, window):
    rng = np.random.default_rng(B * 7 + dk)
    lens = rng.integers(1, NB * blk + 1, B)
    live = np.where(np.arange(B) == 0, lens // 2, 0)    # one pruned row
    args = _tide_on_card(_tide_case(B + H, B, H, KH, dk, dv, NB, blk, lens,
                                    live), card, dtype)
    got = _tide_launch(args, window)
    assert got.dtype == dtype and got.shape == (B, H, dv)
    want = tide_attention_ref(*args, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_tide_attention_empty_slices_on_card(card, dtype, tol):
    """RecurrentGemma's shape splits each row 33 ways; rows of a few tiles
    leave most slices empty, and a row with no live position leaves all."""
    lens, live = [10, 70, 2624, 0], [0, 33, 512, 0]
    args = _tide_on_card(_tide_case(17, 4, 16, 1, 256, 256, 32, 128, lens,
                                    live), card, dtype)
    S, R = tide_kernel.plan(*args[:3], 2048)
    assert S > -(-70 // R) + 1
    got = _tide_launch(args, 2048)
    assert not got[3].any()
    want = tide_attention_ref(*args, window=2048)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _dead_rows(case, window):
    """(B, NB, blk) bool: the arena rows that hold no live position — pruned,
    at or past seq_len, outside the window, and whole blocks the live range
    does not reach."""
    _, ak, _, table, lens, live = case
    B, NB, blk = ak.shape[:3]
    pos = np.arange(NB * blk)[None]
    alive = (pos >= live[:, None]) & (pos < lens[:, None])
    if window > 0:
        alive &= pos > lens[:, None] - 1 - window
    dead = np.ones((B, NB, blk), bool)
    for b in range(B):
        dead[b, table[b]] = ~alive[b].reshape(NB, blk)
    return dead


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,lens,live,window", [
    ((8, 32, 8, 128, 128, 16, 128), [2048, 1500, 700, 1, 129, 1000, 64, 999],
     [512, 0, 640, 0, 0, 100, 0, 0], 0),
    ((4, 16, 1, 256, 256, 32, 128), [2624, 2624, 100, 3000],
     [512, 512, 0, 640], 2048),
    ((2, 16, 2, 64, 32, 5, 64), [300, 200], [70, 0], 48),
    ((2, 8, 2, 64, 64, 6, 8), [40, 17], [9, 0], 0),
    ((3, 16, 4, 64, 32, 5, 24), [100, 47, 120], [30, 0, 50], 40),
])
def test_tide_attention_never_reads_dead_rows(card, dtype, tol, shape, lens,
                                              live, window):
    """Every dead arena row holds NaN: the output must be finite and equal
    the plain version on the same arena with those rows zeroed."""
    B, H, KH, dk, dv, NB, blk = shape
    case = _tide_case(31, B, H, KH, dk, dv, NB, blk, lens, live)
    dead = _dead_rows(case, window)
    q, ak, av, table, ln, lv = case
    clean = (q, np.where(dead[..., None, None], 0, ak),
             np.where(dead[..., None, None], 0, av), table, ln, lv)
    poisoned = (q, np.where(dead[..., None, None], np.nan, ak),
                np.where(dead[..., None, None], np.nan, av), table, ln, lv)
    got = _tide_launch(_tide_on_card(poisoned, card, dtype), window)
    assert torch.isfinite(got.float()).all()
    want = tide_attention_ref(*_tide_on_card(clean, card, dtype),
                              window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tide_attention_empty_rows_on_card(card, dtype):
    """seq_len = 0 and first_live >= seq_len > 0 give exactly 0; the live
    row beside them still matches the plain version."""
    args = _tide_on_card(_tide_case(4, 3, 8, 2, 64, 64, 4, 32, [0, 40, 70],
                                    [0, 64, 16]), card, dtype)
    got = decode_attention(*args)
    torch.cuda.synchronize()
    assert not got[:2].any()
    want = tide_attention_ref(*args)
    assert not want[:2].any()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got[2].float(), want[2].float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_tide_attention_rejects_what_it_cannot_take(card):
    args = _tide_on_card(_tide_case(4, 2, 8, 2, 64, 64, 4, 32, [5, 9],
                                    [0, 0]), card, torch.float32)
    with pytest.raises(TypeError):
        tide_kernel.tide_attention(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        tide_kernel.tide_attention(args[0].transpose(0, 1).contiguous()
                                   .transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="multiples"):
        odd = [a[..., :6].contiguous() for a in args[:3]]
        tide_kernel.tide_attention(*odd, *args[3:])
    with pytest.raises(ValueError, match="multiples of 16"):
        tide_kernel.tide_attention(*[a[..., :40].bfloat16().contiguous()
                                     for a in args[:3]], *args[3:])


def _ssd_on_card(case, card, dtype):
    """(x, dt, A, Bm, Cm, init) on the card: x, Bm, Cm in ``dtype``, the
    rest in fp32."""
    x, dt, A, Bm, Cm, s0 = case
    return ([_t(x).to(card, dtype), _t(dt).to(card), _t(A).to(card),
             _t(Bm).to(card, dtype), _t(Cm).to(card, dtype)],
            None if s0 is None else _t(s0).to(card))


def _ssd_launch(args, c, s0, **kw):
    """ops.ssd through the kernel; checks that each pass ran once (and the
    split of the inputs once in fp32)."""
    before = dict(ssd_kernel.launches)
    got = ssd(*args, chunk=c, init_state=s0, **kw)
    torch.cuda.synchronize()
    split = args[0].dtype == torch.float32
    for name, more in (("ssd_scan", 1), ("ssd_scan_states", 1),
                       ("ssd_scan_pass", 1), ("ssd_scan_split", split)):
        assert ssd_kernel.launches[name] == before[name] + more, name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n,c,init", [
    (8, 2048, 64, 64, 128, 256, False),   # Mamba-2-1.3B prefill
    (2, 1000, 64, 64, 128, 256, True),    # ragged: the padding path
    (2, 100, 64, 64, 128, 256, False),    # l < chunk: c = l
    (2, 64, 8, 16, 32, 16, True),         # TestSsdScan's shapes
    (1, 128, 4, 64, 128, 32, False),
    (3, 48, 8, 16, 16, 16, False),
    (2, 40, 4, 16, 32, 16, False),
    (1, 16384, 64, 64, 128, 256, False),  # one long Mamba-2 prompt
    (2, 96, 6, 16, 32, 32, True),         # h = 6, no block of 4 heads
])
def test_ssd_scan_kernel_on_card(card, b, l, h, p, n, c, init):
    case = _ssd_case(l + h, b, l, h, p, n, init)
    args, s0 = _ssd_on_card(case, card, torch.float32)
    y, st = _ssd_launch(args, c, s0)
    assert y.shape == (b, l, h, p) and st.dtype == torch.float32
    yr, sr = ssd_scan_ref(*args, chunk=c, init_state=s0)
    torch.testing.assert_close(y, yr, rtol=3e-4, atol=3e-4)
    torch.testing.assert_close(st, sr, rtol=3e-4, atol=3e-4)

    # bf16: the kernel widens C and B before their product, the plain
    # version (as the JAX model) rounds C.B^T to bf16 first, so each y is
    # held against the plain version in fp32 on the same rounded inputs.
    # The state is fp32 from those inputs in all three: fp32 tolerance.
    bargs, _ = _ssd_on_card(case, card, torch.bfloat16)
    yk, sk = _ssd_launch(bargs, c, s0)
    yp, _ = ssd_scan_ref(*bargs, chunk=c, init_state=s0)
    y32, s32 = ssd_scan_ref(*[a.float() for a in bargs], chunk=c,
                            init_state=s0)
    assert yk.dtype == torch.bfloat16 and torch.isfinite(yk.float()).all()
    err = (yk.float() - y32).abs().mean()
    assert err <= 1.25 * (yp.float() - y32).abs().mean(), err
    torch.testing.assert_close(sk, s32, rtol=3e-4, atol=3e-4)
    # The kernel's own rounding in plain ops (bf16 inputs exact, each
    # computed fp32 operand as a hi and a lo bf16 part): y element by
    # element within one bf16 ulp (2^-7 relative) and 2^-10 of the mean |y|.
    # A kernel that dropped the lo part of W or of the carried state breaks
    # it; the mean rule above does not see that.
    ym, _ = ssd_scan_passes(*bargs, chunk=c, init_state=s0, split=True)
    torch.testing.assert_close(
        yk.float(), ym.float(), rtol=2.0 ** -7,
        atol=2.0 ** -10 * float(ym.float().abs().mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,c,init", [
    (2, 1000, 64, 64, 128, 256, True),    # Mamba-2 widths, ragged
    (2, 40, 6, 16, 32, 16, False),
])
def test_ssd_scan_reads_only_what_it_wrote(card, dtype, b, l, h, p, n, c,
                                           init):
    """Every scratch element holds NaN before the call: the outputs must be
    finite and equal, bit for bit, to a call on fresh scratch, so each
    element a pass reads was written by the pass before."""
    x, dt, A, Bm, Cm, s0 = _ssd_case(l + 2 * h, b, l, h, p, n, init)
    l = -(-l // c) * c                                 # as ops.ssd pads
    pad = lambda a: np.pad(a, [(0, 0), (0, l - a.shape[1])] +
                           [(0, 0)] * (a.ndim - 2))
    args, s0 = _ssd_on_card((pad(x), pad(dt), A, pad(Bm), pad(Cm), s0),
                            card, dtype)
    sc = ssd_kernel.alloc_scratch(b, l, h, p, n, c, dtype, card)
    for t in sc.values():
        t.fill_(float("nan"))
    y, st = ssd_kernel.ssd_scan(*args, chunk=c, init_state=s0, _scratch=sc)
    yf, sf = ssd_kernel.ssd_scan(*args, chunk=c, init_state=s0)
    torch.cuda.synchronize()
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    assert torch.equal(y, yf) and torch.equal(st, sf)


@pytest.mark.cuda
def test_ssd_scan_rejects_what_it_cannot_take(card):
    args, _ = _ssd_on_card(_ssd_case(1, 1, 32, 4, 16, 16), card,
                           torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        ssd_kernel.ssd_scan(*args, chunk=24)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(args[0].half(), *args[1:], chunk=16)
    with pytest.raises(TypeError):
        ssd_kernel.ssd_scan(*args[:3], args[3].bfloat16(), args[4],
                            chunk=16)
    with pytest.raises(ValueError, match="card"):
        ssd_kernel.ssd_scan(*[a.cpu() for a in args], chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_kernel.ssd_scan(args[0].transpose(1, 2).contiguous()
                            .transpose(1, 2), *args[1:], chunk=16)
    with pytest.raises(ValueError, match="multiples of 16"):
        ssd_kernel.ssd_scan(args[0][..., :8].contiguous(), *args[1:],
                            chunk=16)
    wide = [torch.zeros((1, 32, 144), device=card) for _ in range(2)]
    with pytest.raises(ValueError, match="at most 128"):
        ssd_kernel.ssd_scan(*args[:3], *wide, chunk=16)
    # A scratch from other shapes or for the other entry is refused before
    # the kernels could write past it.
    for sc in (ssd_kernel.alloc_scratch(1, 16, 4, 16, 16, 16, torch.float32,
                                        card),
               ssd_kernel.alloc_scratch(1, 32, 4, 16, 16, 16, torch.bfloat16,
                                        card)):
        with pytest.raises(ValueError, match="scratch"):
            ssd_kernel.ssd_scan(*args, chunk=16, _scratch=sc)
