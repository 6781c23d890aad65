"""The benchmark's byte counts equal those of the port's card checks
(``chip_smoke.py``) on small inputs."""
from __future__ import annotations

import importlib.util

import numpy as np
import pytest
import torch

from tidebench.roofline import bloom_words_needed, lookup_windows_needed
from tidebench.tests.tiny import ROOT


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_counts",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bloom_words_equal_chip_smoke(smoke, seed):
    rng = np.random.default_rng(seed)
    cells, words, nbits = 8, 64, 2048 - 96 * seed   # odd moduli too
    bits, added = smoke._bloom_bits(rng, cells, words, 150, nbits)
    h1, h2, off, nb = smoke._bloom_queries(rng, added, 40, words, nbits)
    want = smoke._bloom_words_needed(_t(h1), _t(h2), _t(off), _t(nb),
                                     _t(bits))
    assert bloom_words_needed(h1, h2, off, nb, bits) == want


@pytest.mark.parametrize("seed,window", [(0, 64), (1, 128), (2, 256)])
def test_lookup_windows_equal_chip_smoke(smoke, seed, window):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, 2**32, 5000, dtype=np.uint32))
    if seed == 2:           # clustered keys: rounds run out for some queries
        keys = np.unique(np.concatenate([keys, np.arange(
            2**31, 2**31 + 3000, dtype=np.uint32)]))
    q = np.concatenate([rng.choice(keys, 300),
                        rng.integers(0, 2**32, 300, dtype=np.uint32),
                        np.arange(2**31, 2**31 + 3000, 10, dtype=np.uint32)])
    want = smoke._lookup_windows_needed(_t(q), _t(keys), window, 4)
    got, unresolved = lookup_windows_needed(q, keys, window, 4)
    assert got == want
    assert unresolved >= 0
