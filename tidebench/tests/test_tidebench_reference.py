"""The reference catches a store that returns one wrong byte, drops one key
or gives one wrong existence answer, and holds retention as stated."""
from __future__ import annotations

import pytest

from tidebench.reference import Expired, ReferenceStore
from tidebench.traffic import Traffic, value_of


def _store(retain=None):
    t = Traffic(7, 32, 1024)
    ref = ReferenceStore(retain)
    items = t.fresh(100, epoch=1)
    ref.put_many(items, epoch=1)
    return t, ref, items


def test_reference_catches_one_wrong_byte():
    t, ref, items = _store()
    keys = [k for k, _ in items]
    got = [v for _, v in items]
    assert ref.wrong_values(keys, got) == 0
    got[37] = got[37][:500] + bytes([got[37][500] ^ 0x80]) + got[37][501:]
    assert ref.wrong_values(keys, got) == 1


def test_reference_catches_one_dropped_key():
    t, ref, items = _store()
    keys = [k for k, _ in items]
    got = [v for _, v in items]
    got[5] = None
    assert ref.wrong_values(keys, got) == 1
    assert ref.wrong_exists(keys, [True] * 99 + [False]) == 1
    assert ref.wrong_values(keys, got[:-1]) == len(keys)


def test_reference_catches_one_wrong_existence_answer():
    t, ref, items = _store()
    absent = t.never_written(50)
    keys = [k for k, _ in items] + absent
    answers = [True] * 100 + [False] * 50
    assert ref.wrong_exists(keys, answers) == 0
    answers[120] = True
    assert ref.wrong_exists(keys, answers) == 1


def test_retention_fixes_only_the_newest_epochs():
    t = Traffic(9, 32, 64)
    ref = ReferenceStore(retain_epochs=2)
    old = t.fresh(10, epoch=1)
    ref.put_many(old, epoch=1)
    mid = t.fresh(10, epoch=2)
    ref.put_many(mid, epoch=2)
    new = t.fresh(10, epoch=3)
    ref.put_many(new, epoch=3)
    assert ref.epoch_floor() == 2
    assert all(ref.exists(k) for k, _ in mid + new)
    with pytest.raises(Expired):
        ref.exists(old[0][0])
    assert ref.exists(old[0][0], floor=1)      # as it stood before epoch 3
    assert t.first_index_of_epoch(2) == 10


def test_traffic_is_the_seeds():
    a, b = Traffic(2**33 + 5, 32, 1024), Traffic(2**33 + 5, 32, 1024)
    assert a.fresh(8) == b.fresh(8)
    assert a.mixed(64, 0.5) == b.mixed(64, 0.5)
    c = Traffic(2**33 + 6, 32, 1024)
    assert c.fresh(8) != Traffic(2**33 + 5, 32, 1024).fresh(8)
    k = a.written.key(3)
    assert value_of(k, 1024) == k * 32
    keys = a.mixed(1000, 0.25)
    written = {a.written.key(i) for i in range(a.written.n)}
    assert sum(k in written for k in keys) == 250
