"""``lookup_positions`` and ``bloom_add_ref`` against the JAX package's, bit
for bit: the mirrors of the cases of ``tests/test_kernels.py`` that use them
(``TestOptimisticLookup::test_ops_fallback_exact`` and ``test_property``,
``TestBloomCheck``, ``TestBloomCheckRagged::test_vs_ref_and_flat_percell``).
The port's functions run their plain versions here (CPU tensors); the JAX
package's kernels run in interpret mode."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hypothesis_compat import HealthCheck, given, settings, st

from repro.kernels.bloom_check.kernel import bloom_check as jax_bloom_check
from repro.kernels.bloom_check.kernel import \
    bloom_check_ragged as jax_bloom_check_ragged
from repro.kernels.bloom_check.ref import bloom_add_ref as jax_bloom_add_ref
from repro.kernels.optimistic_lookup.ops import \
    lookup_positions as jax_lookup_positions
from repro.kernels.optimistic_lookup.ref import \
    optimistic_lookup_ref as jax_lookup_ref
from repro_torch.kernels.bloom_check.ops import might_contain, probe_ragged
from repro_torch.kernels.bloom_check.ref import bloom_add_ref
from repro_torch.kernels.optimistic_lookup.ops import lookup_positions

SETTINGS = settings(max_examples=15, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_positions(queries, keys, pos, **kw):
    got, found = lookup_positions(_t(queries), _t(keys), _t(pos), **kw)
    want, wfound = jax_lookup_positions(jnp.asarray(queries),
                                        jnp.asarray(keys), jnp.asarray(pos),
                                        **kw)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(found.numpy(), np.asarray(wfound))
    ridx, rfound = jax_lookup_ref(jnp.asarray(queries), jnp.asarray(keys))
    exp = np.where(np.asarray(rfound),
                   pos[np.clip(np.asarray(ridx), 0, len(keys) - 1)], 0)
    np.testing.assert_array_equal(got.numpy(), exp)
    np.testing.assert_array_equal(found.numpy(), np.asarray(rfound))


def test_lookup_positions_fallback_exact():
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 2**32, 5000, dtype=np.uint32))
    # adversarial: clustered keys break the uniformity assumption
    keys = np.unique(np.concatenate([keys, np.arange(
        2**31, 2**31 + 4096, dtype=np.uint32)]))
    queries = np.concatenate([
        keys[:64], rng.integers(0, 2**32, 64, dtype=np.uint32)
    ]).astype(np.uint32)
    pos = np.arange(len(keys), dtype=np.uint32) * 40
    _same_positions(queries, keys, pos, window=128, max_iters=2)


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(10, 3000),
       window=st.sampled_from([128, 512]))
@SETTINGS
def test_lookup_positions_property(seed, n, window):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(0, 2**32, n, dtype=np.uint32))
    queries = np.concatenate([
        rng.choice(keys, 16), rng.integers(0, 2**32, 16, dtype=np.uint32)
    ]).astype(np.uint32)
    pos = np.arange(len(keys), dtype=np.uint32) + 7
    _same_positions(queries, keys, pos, window=window)


def _add(h1, h2, bits, **kw):
    """Both packages' bloom_add_ref on the same input, bit for bit."""
    got = bloom_add_ref(_t(h1), _t(h2), _t(bits), **kw)
    want = jax_bloom_add_ref(jnp.asarray(h1), jnp.asarray(h2),
                             jnp.asarray(bits), **kw)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got.numpy()


class TestBloomCheck:
    @pytest.mark.parametrize("nwords,nadd,k", [(64, 20, 7), (256, 100, 7),
                                               (1024, 500, 5)])
    def test_vs_ref_no_false_negatives(self, nwords, nadd, k):
        rng = np.random.default_rng(nwords)
        h1a = rng.integers(0, 2**32, nadd, dtype=np.uint32)
        h2a = rng.integers(0, 2**32, nadd, dtype=np.uint32) | 1
        bits = _add(h1a, h2a, np.zeros(nwords, np.uint32), k=k)
        h1q = np.concatenate([h1a, rng.integers(0, 2**32, 200,
                                                dtype=np.uint32)])
        h2q = np.concatenate([h2a, rng.integers(0, 2**32, 200,
                                                dtype=np.uint32) | 1])
        out = might_contain(_t(h1q), _t(h2q), _t(bits), k=k).numpy()
        want = jax_bloom_check(jnp.asarray(h1q), jnp.asarray(h2q),
                               jnp.asarray(bits), k=k, interpret=True)
        np.testing.assert_array_equal(out, np.asarray(want))
        assert out[:nadd].all()                   # no false negatives
        assert out[nadd:].mean() < 0.35           # bounded false positives

    @given(seed=st.integers(0, 2**31 - 1))
    @SETTINGS
    def test_property(self, seed):
        rng = np.random.default_rng(seed)
        h1 = rng.integers(0, 2**32, 30, dtype=np.uint32)
        h2 = rng.integers(0, 2**32, 30, dtype=np.uint32) | 1
        bits = _add(h1, h2, np.zeros(128, np.uint32))
        assert might_contain(_t(h1), _t(h2), _t(bits)).all()

    def test_duplicate_words_accumulate_and_nbits(self):
        """Two hashes that set bits of one word in one batch both land,
        and a modulus below the word count's keeps bits under it."""
        h1 = np.array([0, 1, 0, 1], np.uint32)
        h2 = np.full(4, 3, np.uint32)
        bits = _add(h1, h2, np.zeros(4, np.uint32), k=3)
        assert bits[0] == sum(1 << b for b in (0, 1, 3, 4, 6, 7))
        narrow = _add(np.arange(50, dtype=np.uint32),
                      np.full(50, 7, np.uint32), np.zeros(8, np.uint32),
                      nbits=100)
        assert (narrow[4:] == 0).all() and narrow[3] < (1 << 4)


class TestBloomCheckRagged:
    def _cells(self, seed, nwords_list, nadd_list, k=7):
        rng = np.random.default_rng(seed)
        cells = []
        for nwords, nadd in zip(nwords_list, nadd_list):
            h1a = rng.integers(0, 2**32, nadd, dtype=np.uint32)
            h2a = rng.integers(0, 2**32, nadd, dtype=np.uint32) | 1
            bits = _add(h1a, h2a, np.zeros(nwords, np.uint32), k=k)
            cells.append((bits, h1a, h2a, nwords * 32))
        return cells

    @pytest.mark.parametrize("nwords_list,nadd_list", [
        ([64, 256, 16], [20, 100, 4]),
        ([2, 128, 2, 1024], [0, 50, 1, 400]),     # empty + tiny cells
        ([512], [200]),                           # single cell
    ])
    def test_vs_ref_and_flat_percell(self, nwords_list, nadd_list):
        cells = self._cells(7, nwords_list, nadd_list)
        rng = np.random.default_rng(8)
        h1, h2, off, nb, base = [], [], [], [], 0
        for bits, h1a, h2a, nbits in cells:
            h1m = rng.integers(0, 2**32, 25, dtype=np.uint32)
            h2m = rng.integers(0, 2**32, 25, dtype=np.uint32) | 1
            h1 += [h1a, h1m]
            h2 += [h2a, h2m]
            off.append(np.full(len(h1a) + 25, base, np.int32))
            nb.append(np.full(len(h1a) + 25, nbits, np.uint32))
            base += len(bits)
        args = [np.concatenate(a) for a in (h1, h2, off, nb)] + \
            [np.concatenate([c[0] for c in cells])]
        out = probe_ragged(*[_t(a) for a in args]).numpy()
        want = jax_bloom_check_ragged(*[jnp.asarray(a) for a in args],
                                      interpret=True)
        np.testing.assert_array_equal(out, np.asarray(want))
        pos = 0
        for bits, h1a, h2a, nbits in cells:
            q = len(h1a) + 25
            flat = might_contain(_t(args[0][pos:pos + q]),
                                 _t(args[1][pos:pos + q]), _t(bits),
                                 nbits=nbits).numpy()
            np.testing.assert_array_equal(out[pos:pos + q], flat)
            assert out[pos:pos + len(h1a)].all()
            pos += q
