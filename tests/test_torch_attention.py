"""The port's tide_attention and KV-WAL against the JAX package's.

On the CPU ``decode_attention`` takes the kernel's plain PyTorch version; it
is held against the Pallas kernel run in interpret mode and against the JAX
oracle ``tide_attention_ref``, over the cases and tolerances of
``TestTideAttention`` in ``tests/test_kernels.py``.  Inputs are made from a
seed with numpy and handed to both.  Rows with no live position are the one
deliberate difference: the port returns 0 there (see ``ref.py``).  The CUDA
kernel is held against the plain version in ``test_torch_kernels_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvwal as jax_kvwal
from repro.kernels.tide_attention.kernel import \
    tide_attention as jax_tide_attention
from repro.kernels.tide_attention.ref import \
    tide_attention_ref as jax_tide_attention_ref
from repro_torch.core import kvwal
from repro_torch.kernels.tide_attention import kernel as tide_kernel
from repro_torch.kernels.tide_attention.ops import decode_attention
from repro_torch.kernels.tide_attention.ref import tide_attention_ref
from test_torch_kernels_cuda import _tide_case


def _both(case, *, window=0, dtype=np.float32):
    """(Pallas interpret, JAX oracle, port) outputs as float32 numpy."""
    q, ak, av, table, lens, live = case
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, ak, av)] + [
        jnp.asarray(a) for a in (table, lens, live)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, ak, av)] + [
        torch.from_numpy(a) for a in (table, lens, live)]
    pallas = jax_tide_attention(*jargs, window=window, interpret=True)
    oracle = jax_tide_attention_ref(*jargs, window=window)
    port = decode_attention(*targs, window=window)
    assert port.dtype == tdt and port.shape == q.shape[:2] + (av.shape[-1],)
    return (np.asarray(pallas.astype(jnp.float32)),
            np.asarray(oracle.astype(jnp.float32)), port.float().numpy())


def _assert_all_close(outs, tol):
    pallas, oracle, port = outs
    np.testing.assert_allclose(port, pallas, rtol=tol, atol=tol)
    np.testing.assert_allclose(port, oracle, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KH,dk,dv,NB,blk", [
    (2, 8, 4, 64, 64, 4, 32),        # GQA
    (1, 4, 1, 128, 128, 3, 128),     # MQA, one 128-slot block a tile
    (3, 4, 4, 32, 32, 2, 16),        # MHA
    (2, 16, 2, 64, 32, 5, 64),       # dk != dv
])
def test_shapes_match_jax(B, H, KH, dk, dv, NB, blk):
    rng = np.random.default_rng(B * 131 + H)
    lens = rng.integers(1, NB * blk + 1, B)
    case = _tide_case(B * 131 + H, B, H, KH, dk, dv, NB, blk, lens, [0] * B)
    _assert_all_close(_both(case), 2e-5)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_dtypes_match_jax(dtype, tol):
    case = _tide_case(3, 2, 8, 4, 64, 64, 4, 32, [120, 77], [0, 16])
    _assert_all_close(_both(case, dtype=dtype), tol)


def test_epoch_pruning_matches_jax():
    """first_live masking == attending only to live segments."""
    case = _tide_case(9, 2, 4, 2, 32, 32, 6, 16, [90, 96], [32, 48])
    _assert_all_close(_both(case), 2e-5)


@pytest.mark.parametrize("window", [16, 48, 100])
def test_sliding_window_matches_jax(window):
    case = _tide_case(11, 2, 4, 4, 32, 32, 8, 16, [128, 70], [0, 0])
    _assert_all_close(_both(case, window=window), 2e-5)


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_match_jax(seed):
    lens = np.random.default_rng(seed).integers(1, 129, 2)
    case = _tide_case(100 + seed, 2, 4, 2, 32, 32, 4, 32, lens, [0, 0])
    _assert_all_close(_both(case), 2e-5)


def test_empty_rows():
    """Row 0: seq_len = 0.  Row 1: first_live >= seq_len > 0.  Row 2: live.
    The port returns 0 for both empty rows.  The Pallas kernel returns 0 for
    the first but, for the second, the mean of V over the first
    ceil(seq_len / blk) logical blocks: it runs every block that starts
    below seq_len with every score at -1e30, so every weight is 1."""
    blk, seq_len = 16, 20
    case = _tide_case(21, 3, 4, 2, 32, 32, 4, blk, [0, seq_len, 50],
                      [0, 32, 16])
    pallas, _, port = _both(case)
    assert not port[:2].any()
    np.testing.assert_array_equal(pallas[0], 0)
    _, _, av, table, _, _ = case
    nb = -(-seq_len // blk)
    v = av[1, table[1, :nb]].reshape(nb * blk, 2, 32)  # (positions, KH, dv)
    want = np.repeat(v.mean(axis=0), 2, axis=0)         # G = 2 heads a kv-head
    np.testing.assert_allclose(pallas[1], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port[2], pallas[2], rtol=2e-5, atol=2e-5)


def test_decode_attention_routes_by_device():
    case = _tide_case(5, 2, 4, 2, 32, 32, 2, 16, [20, 7], [0, 0])
    args = [torch.from_numpy(a) for a in case]
    before = tide_kernel.launches["tide_attention"]
    assert torch.equal(decode_attention(*args), tide_attention_ref(*args))
    assert tide_kernel.launches["tide_attention"] == before
    # A meta tensor (the dry run's shape record) takes the plain version.
    meta = decode_attention(*[a.to("meta") for a in args])
    assert meta.is_meta and meta.shape == tide_attention_ref(*args).shape
    assert tide_kernel.launches["tide_attention"] == before
    with pytest.raises(ValueError, match="must lie on the card"):
        tide_kernel.tide_attention(*args)


# ------------------------------------------------------------------ KV-WAL

def _spec_pair(**kw):
    return (jax_kvwal.KVWalSpec(**kw, dtype="float32"),
            kvwal.KVWalSpec(**kw, dtype="float32"))


def _eq(jax_array, tensor):
    np.testing.assert_array_equal(np.asarray(jax_array), tensor.numpy())


def test_kvwal_init_cache_matches_jax():
    jspec, tspec = _spec_pair(n_layers=2, batch=3, max_seq=50, kv_heads=2,
                              entry_dim=4, block_size=8)
    assert tspec.arena_shape() == jspec.arena_shape()
    jc = jax_kvwal.init_cache(jspec)
    tc = kvwal.init_cache(tspec, device="cpu")
    assert set(jc) == set(tc)
    for k in jc:
        _eq(jc[k], tc[k])
        assert tc[k].dtype == {"arena": torch.float32}.get(k, torch.int32)


def test_kvwal_append_and_gather_match_jax():
    B, NB, blk, KH, D = 3, 4, 8, 2, 4
    rng = np.random.default_rng(0)
    arena = rng.standard_normal((B, NB, blk, KH, D)).astype(np.float32)
    table = np.stack([rng.permutation(NB) for _ in range(B)]).astype(np.int32)
    # the last length runs past the arena's end: both clamp to the last block
    lens = np.array([0, 9, 40], np.int32)
    entry = rng.standard_normal((B, KH, D)).astype(np.float32)
    want = jax_kvwal.append_token(jnp.asarray(arena), jnp.asarray(table),
                                  jnp.asarray(lens), jnp.asarray(entry))
    got = kvwal.append_token(torch.from_numpy(arena.copy()),
                             torch.from_numpy(table), torch.from_numpy(lens),
                             torch.from_numpy(entry))
    _eq(want, got)
    _eq(jax_kvwal.gather(want, jnp.asarray(table)),
        kvwal.gather(got, torch.from_numpy(table)))


@pytest.mark.parametrize("S", [5, 8, 11, 32])
def test_kvwal_write_prefill_matches_jax(S):
    rng = np.random.default_rng(S)
    arena = rng.standard_normal((2, 4, 8, 1, 2)).astype(np.float32)
    entries = rng.standard_normal((2, S, 1, 2)).astype(np.float32)
    want = jax_kvwal.write_prefill(jnp.asarray(arena), jnp.asarray(entries))
    got = kvwal.write_prefill(torch.from_numpy(arena.copy()),
                              torch.from_numpy(entries))
    _eq(want, got)


def test_kvwal_prune_and_free_blocks_match_jax():
    jspec, tspec = _spec_pair(n_layers=1, batch=2, max_seq=64, kv_heads=1,
                              entry_dim=2, block_size=8)
    jc = jax_kvwal.init_cache(jspec)
    tc = kvwal.init_cache(tspec, device="cpu")
    for live in ([20, 7], [8, 8], [63, 17]):     # the watermark is monotonic
        jc = jax_kvwal.prune_below(jc, jnp.asarray(live, jnp.int32))
        tc = kvwal.prune_below(tc, torch.tensor(live, dtype=torch.int32))
        _eq(jc["first_live"], tc["first_live"])
        _eq(jax_kvwal.free_blocks(jc), kvwal.free_blocks(tc))
        assert tc["first_live"].dtype == torch.int32
