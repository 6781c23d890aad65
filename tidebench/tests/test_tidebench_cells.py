"""Each cell's loop, tiny and on the CPU: a sound store passes, and the
comparison that decides ``correct`` fails the control and each fault a
cell's timed path can have."""
from __future__ import annotations

import pytest

from tidebench.control import control_factory
from tidebench.drivers.store import db_config, run
from tidebench.run import ROOT, result_of
from tidebench.tests.tiny import CELLS, PROGRAMS, tiny_cell

RUNS = CELLS + tuple(PROGRAMS)

SEED = 2**31 + 12345          # larger than 32 signed bits hold
DEVICE = {"platform": "cpu"}


def _verdict(name, store_factory=None, rounds=4):
    config, workload = tiny_cell(name)
    out = run(config, workload, SEED, 60.0, device="cpu", max_rounds=rounds,
              store_factory=store_factory(config) if store_factory else None)
    return out, result_of(ROOT, name, workload, out, DEVICE, trace=False)


@pytest.mark.parametrize("name", RUNS)
def test_sound_store_is_correct(name):
    out, res = _verdict(name)
    assert res["correct"], res["checks"]
    assert out["rounds"] == 4 and out["failed"] == 0
    assert res["attempted"] > 0
    assert "setup_s" in res["metrics"]
    assert bool(out["space_samples"]) == (name == "test.write")
    assert set(res["checks"]) <= {"wrong_exists", "wrong_values",
                                  "lost_after_reopen"}


@pytest.mark.parametrize("name", RUNS)
def test_control_is_not_correct(name):
    _out, res = _verdict(name, control_factory, rounds=32)
    assert not res["correct"]
    assert res["checks"]["wrong_exists"]["value"] > 0


def _tide(config):
    from repro_torch.core.tidestore import TideDB
    return TideDB, db_config(config, "cpu")


def _faulty(method, broken):
    """A store factory whose ``method`` is replaced by ``broken(orig, ...)``."""
    def factory(config):
        tide, cfg = _tide(config)

        class Faulty(tide):
            pass
        setattr(Faulty, method,
                lambda self, *a, **kw: broken(getattr(super(Faulty, self),
                                                      method), *a, **kw))
        return lambda path: Faulty(path, cfg)
    return factory


def _unchanged_put(orig, items, **kw):
    return [None] * len(list(items))         # acknowledges, writes nothing


def _half_put(orig, items, **kw):
    items = list(items)
    orig(items[:len(items) // 2], **kw)
    return [None] * len(items)


def _altered_put(orig, items, **kw):
    items = list(items)
    k, v = items[-1]
    items[-1] = (k, bytes([v[0] ^ 1]) + v[1:])
    return orig(items, **kw)


def _half_get(orig, keys, **kw):
    got = orig(keys[:len(keys) // 2], **kw)
    return got + [None] * (len(keys) - len(got))


def _altered_get(orig, keys, **kw):
    got = orig(keys, **kw)
    i = next(j for j, v in enumerate(got) if v is not None)
    got[i] = bytes([got[i][0] ^ 1]) + got[i][1:]
    return got


def _altered_exists(orig, keys, **kw):
    got = orig(keys, **kw)
    got[0] = not got[0]
    return got


FAULTS = {
    "test.write": [("put_many", _unchanged_put), ("put_many", _half_put),
                      ("put_many", _altered_put),
                      ("multi_exists", _altered_exists)],
    "tide-1k.read": [("put_many", _unchanged_put), ("put_many", _half_put),
                     ("put_many", _altered_put),
                     ("multi_get", _half_get), ("multi_get", _altered_get),
                     ("multi_exists", _altered_exists)],
    "test.ingest": [("put_many", _unchanged_put),
                             ("put_many", _half_put),
                             ("put_many", _altered_put),
                             ("multi_exists", _altered_exists)],
}


@pytest.mark.parametrize("name,method,broken", [
    (name, method, broken) for name, faults in FAULTS.items()
    for method, broken in faults],
    ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(name, method, broken):
    _out, res = _verdict(name, _faulty(method, broken))
    assert not res["correct"], res["checks"]
