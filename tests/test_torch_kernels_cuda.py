"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips without an NVIDIA card.  The
file imports neither JAX nor the JAX package, so it runs on the machine
with the card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

Everything is integer, so kernel and plain version must be equal.  The
input builders here are shared with ``test_torch_kernels.py``.
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
from repro_torch.kernels.optimistic_lookup.ref import optimistic_lookup_ref


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
    before = lookup_kernel.launches["optimistic_lookup"]
    got = lookup_ops.lookup_indices_batch(queries, keys, window=window,
                                          max_iters=max_iters, device="cuda")
    assert lookup_kernel.launches["optimistic_lookup"] == before + 1
    want = lookup_ops.lookup_indices_batch(queries, keys, window=window,
                                           max_iters=max_iters, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


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
