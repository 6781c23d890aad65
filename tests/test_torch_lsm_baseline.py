"""The LSM baseline (the paper's RocksDB and BlobDB stand-ins) against the
JAX package's: seeded traces of puts, overwrites and deletes run on both
packages' ``LsmBaseline`` leave byte-identical run files and vlogs and
equal write counters, and the port answers every key as a dict oracle
does.  The reference reads records through numpy ``S{n}`` fields, which
drop trailing NUL bytes (ROADMAP C.13): its reads are pinned here as they
are, beside the port's, which return the written bytes."""
import os
import struct

import numpy as np
import pytest

from repro.core.lsm_baseline import LsmBaseline as RefLsm
from repro.core.lsm_baseline import LsmConfig as RefConfig
from repro_torch.core.lsm_baseline import LsmBaseline, LsmConfig

KEY, VALUE, MEMTABLE = 32, 48, 64


def _key(rng) -> bytes:
    k = rng.bytes(KEY)
    return k[:-1] + b"\x00" if rng.random() < 0.1 else k


def _value(rng) -> bytes:
    v = rng.bytes(VALUE)
    return v[:-2] + b"\x00\x00" if rng.random() < 0.2 else v


def _trace(seed: int, n_ops: int = 2400):
    """(op, key, value) triples: puts of new keys, overwrites and deletes
    of written ones; one key in ten and one value in five end in NUL."""
    rng = np.random.default_rng(seed)
    keys, ops = [], []
    for _ in range(n_ops):
        r = rng.random()
        if keys and r < 0.15:
            ops.append(("delete", keys[rng.integers(len(keys))], None))
        elif keys and r < 0.35:
            ops.append(("put", keys[rng.integers(len(keys))], _value(rng)))
        else:
            keys.append(_key(rng))
            ops.append(("put", keys[-1], _value(rng)))
    return ops, keys


def _run(engine, ops) -> dict:
    oracle = {}
    for op, k, v in ops:
        if op == "put":
            engine.put(k, v)
            oracle[k] = v
        else:
            engine.delete(k)
            oracle[k] = None
    return oracle


def _files(path) -> dict:
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


def _check_answers(db, oracle, absent):
    for k, v in oracle.items():
        assert db.get(k) == v
        assert db.exists(k) == (v is not None)
    for k in absent:
        assert db.get(k) is None and not db.exists(k)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("compaction", [True, False])
@pytest.mark.parametrize("blob_mode", [False, True])
def test_trace_matches_the_reference(tmp_path, blob_mode, compaction, seed):
    ops, keys = _trace(seed)
    kw = dict(memtable_entries=MEMTABLE, blob_mode=blob_mode,
              compaction=compaction)
    ref = RefLsm(str(tmp_path / "ref"), RefConfig(**kw))
    port = LsmBaseline(str(tmp_path / "port"), LsmConfig(**kw))
    oracle = _run(ref, ops)
    assert _run(port, ops) == oracle
    if compaction:                       # merges have reached L2
        assert len(port.levels) >= 3 and port.levels[2]
    rng = np.random.default_rng(seed + 100)
    absent = [_key(rng) for _ in range(64)]
    _check_answers(port, oracle, absent)
    ref.flush()
    port.flush()
    _check_answers(port, oracle, absent)
    ref_files, port_files = _files(ref.path), _files(port.path)
    assert list(port_files) == list(ref_files)
    assert any(n.endswith(".sst") for n in port_files)
    assert ("vlog" in port_files) == blob_mode
    for name in ref_files:
        assert port_files[name] == ref_files[name], name
    for field in ("bytes_written_app", "bytes_written_disk"):
        assert port.stats()[field] == ref.stats()[field]
    assert [[r.count for r in lv] for lv in port.levels] == \
        [[r.count for r in lv] for lv in ref.levels]
    ref.close()
    port.close()


@pytest.mark.parametrize("blob_mode", [False, True])
def test_reads_return_the_written_bytes(tmp_path, blob_mode):
    """C.13: after a flush the reference returns a value that ends in NUL
    short, misses a key that ends in NUL, and in BlobDB mode returns every
    value as its vlog pointer cut short of 12 bytes; the port returns what
    was written, reading the vlog."""
    kw = dict(memtable_entries=MEMTABLE, blob_mode=blob_mode)
    ref = RefLsm(str(tmp_path / "ref"), RefConfig(**kw))
    port = LsmBaseline(str(tmp_path / "port"), LsmConfig(**kw))
    plain = (b"k" * (KEY - 1) + b"a", b"v" * VALUE)
    nul_value = (b"k" * (KEY - 1) + b"b", b"w" * (VALUE - 1) + b"\x00")
    nul_key = (b"k" * (KEY - 1) + b"\x00", b"x" * VALUE)
    for db in (ref, port):
        for k, v in (plain, nul_value, nul_key):
            db.put(k, v)
        db.flush()
    for k, v in (plain, nul_value, nul_key):
        assert port.get(k) == v and port.exists(k)
    assert ref.get(nul_key[0]) is None and not ref.exists(nul_key[0])
    if blob_mode:
        for k, v in (plain, nul_value):
            got = ref.get(k)
            assert len(got) < 12
            _, vlen = struct.unpack("<QI", got.ljust(12, b"\x00"))
            assert vlen == VALUE
        assert port.stats()["bytes_read_disk"] > ref.stats()["bytes_read_disk"]
    else:
        assert ref.get(plain[0]) == plain[1]
        assert ref.get(nul_value[0]) == nul_value[1][:-1]
    assert _files(port.path) == _files(ref.path)
    ref.close()
    port.close()


def test_refuses_other_value_sizes_and_close_keeps_the_runs(tmp_path):
    """As the reference: values of another size are refused, and ``close``
    leaves the run files in place."""
    db = LsmBaseline(str(tmp_path), LsmConfig(memtable_entries=4))
    for i in range(4):
        db.put(bytes([i]) * KEY, b"v" * VALUE)
    with pytest.raises(ValueError):
        db.put(b"z" * KEY, b"short")
    db.close()
    assert [n for n in os.listdir(tmp_path) if n.endswith(".sst")]
