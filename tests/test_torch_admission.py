"""Admission control for the batch server: cost accounting, the shed and
backpressure policies (bounded queue, hysteresis, zero loss), and the
deterministic stalled-store overload scenario.

The port's mirror of ``tests/test_admission.py``: the same cases and
assertions over the port's ``serving/admission.py`` and ``KvBatchServer``,
every store on ``device="cpu"``, where the batched reads take the kernels'
plain versions.
"""
import hashlib
import shutil
import tempfile
import threading

import pytest

from repro_torch.core.tidestore import DbConfig, KeyspaceConfig, TideDB
from repro_torch.core.tidestore.wal import WalConfig
from repro_torch.serving.admission import (
    AdmissionConfig, AdmissionController, Overloaded)
from repro_torch.serving.engine import KvBatchServer


def small_cfg(**kw):
    defaults = dict(
        device="cpu",
        keyspaces=[KeyspaceConfig("default", n_cells=8,
                                  dirty_flush_threshold=64)],
        wal=WalConfig(segment_size=64 * 1024, background=False),
        index_wal=WalConfig(segment_size=1 * 1024 * 1024, background=False),
        background_snapshots=False,
        cache_bytes=0,
    )
    defaults.update(kw)
    return DbConfig(**defaults)


def keys_n(n, tag=""):
    return [hashlib.sha256(f"{tag}{i}".encode()).digest() for i in range(n)]


@pytest.fixture()
def tmpdir():
    d = tempfile.mkdtemp(prefix="tide-admission-")
    yield d
    shutil.rmtree(d, ignore_errors=True)


# ------------------------------------------------------------------ config
class TestAdmissionConfig:
    def test_validation(self):
        with pytest.raises(ValueError):
            AdmissionConfig(high_watermark=0)
        with pytest.raises(ValueError):
            AdmissionConfig(low_watermark=2000.0)   # above high
        with pytest.raises(ValueError):
            AdmissionConfig(policy="panic")
        with pytest.raises(ValueError):
            AdmissionConfig(read_cost=-1.0)
        cfg = AdmissionConfig(high_watermark=100.0)
        assert cfg.resolved_low == 50.0             # default hysteresis
        assert AdmissionConfig(high_watermark=100.0,
                               low_watermark=80.0).resolved_low == 80.0

    def test_cost_model(self):
        ctl = AdmissionController(AdmissionConfig())

        class R:
            def __init__(self, op, value=None):
                self.op, self.value = op, value

        read = ctl.cost_of(R("get"))
        exists = ctl.cost_of(R("exists"))
        small_put = ctl.cost_of(R("put", b"x"))
        big_put = ctl.cost_of(R("put", b"x" * 64 * 1024))
        delete = ctl.cost_of(R("delete"))
        assert exists < read                        # existence is cheaper
        assert big_put > small_put                  # per-KB surcharge
        assert big_put == pytest.approx(1.0 + 0.25 * 64)
        assert delete == pytest.approx(1.0)


# -------------------------------------------------------------------- shed
class TestShedPolicy:
    def test_sheds_at_watermark_and_recovers(self):
        ctl = AdmissionController(AdmissionConfig(high_watermark=4.0,
                                                  policy="shed"))
        for _ in range(4):
            ctl.admit(1.0)
        with pytest.raises(Overloaded) as ei:
            ctl.admit(1.0)
        assert ei.value.queued_cost == pytest.approx(4.0)
        assert ei.value.high_watermark == pytest.approx(4.0)
        s = ctl.stats()
        assert s["admission_shed"] == 1
        assert s["admission_admitted"] == 4
        assert s["admission_queued_cost"] == pytest.approx(4.0)
        # draining re-opens the door
        ctl.release(2.0)
        ctl.admit(1.0)
        assert ctl.stats()["admission_queued_cost"] == pytest.approx(3.0)

    def test_oversized_single_request_still_admitted_when_idle(self):
        # a request dearer than the watermark must not deadlock an idle
        # controller: with nothing queued it is admitted anyway
        ctl = AdmissionController(AdmissionConfig(high_watermark=2.0,
                                                  policy="backpressure"))
        ctl.admit(5.0)
        assert ctl.stats()["admission_queued_cost"] == pytest.approx(5.0)

    def test_server_sheds_when_stalled(self, tmpdir):
        """Deterministic overload: nobody calls step(), so the queue can
        only grow — admission must hit the watermark and shed, and the
        queue must stay bounded."""
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=8.0, policy="shed"))
            shed = 0
            for k in keys_n(50):
                try:
                    srv.submit_get(k)
                except Overloaded:
                    shed += 1
            assert shed == 50 - 8               # exactly watermark admitted
            assert len(srv.queue) == 8          # bounded, not 50
            # serving drains the accounted cost and re-opens admission
            srv.step()
            assert srv.stats()["admission_queued_cost"] == pytest.approx(0.0)
            srv.submit_get(keys_n(1, "again")[0])
            srv.step()


# ------------------------------------------------------------ backpressure
class TestBackpressurePolicy:
    def test_waiter_unblocks_at_low_watermark(self):
        ctl = AdmissionController(AdmissionConfig(high_watermark=4.0,
                                                  low_watermark=2.0))
        for _ in range(4):
            ctl.admit(1.0)
        entered = threading.Event()
        admitted = threading.Event()

        def blocked():
            entered.set()
            ctl.admit(1.0)
            admitted.set()

        t = threading.Thread(target=blocked, daemon=True)
        t.start()
        assert entered.wait(2.0)
        assert not admitted.wait(0.15)          # full queue: caller parks
        ctl.release(1.0)                        # 3.0 > low: still parked
        assert not admitted.wait(0.15)
        ctl.release(1.0)                        # 2.0: charging would exceed
        assert not admitted.wait(0.15)          # low, so still parked
        ctl.release(1.0)                        # 1.0 + cost 1.0 ≤ low: wakes
        assert admitted.wait(2.0)
        t.join(2.0)
        assert ctl.stats()["admission_waits"] == 1

    def test_oversized_request_admits_at_low_watermark(self):
        """cost > low can never satisfy the hysteresis predicate; it must
        admit once the queue drains TO the low watermark instead of
        starving until the queue is completely empty (which continuous
        small traffic may never allow)."""
        ctl = AdmissionController(AdmissionConfig(high_watermark=4.0,
                                                  low_watermark=2.0))
        for _ in range(4):
            ctl.admit(1.0)
        admitted = threading.Event()

        def blocked():
            ctl.admit(3.0)                      # oversized: 3.0 > low 2.0
            admitted.set()

        t = threading.Thread(target=blocked, daemon=True)
        t.start()
        ctl.release(1.0)                        # 3.0 > low: still parked
        assert not admitted.wait(0.15)
        ctl.release(1.0)                        # 2.0 == low: wakes (queue
        assert admitted.wait(2.0)               # never had to empty)
        t.join(2.0)
        # transient overshoot by the one oversized request is documented
        assert ctl.stats()["admission_queued_cost"] == pytest.approx(5.0)

    def test_timeout_escalates_to_shed(self):
        ctl = AdmissionController(AdmissionConfig(high_watermark=2.0,
                                                  max_wait_s=0.05))
        ctl.admit(1.0)
        ctl.admit(1.0)
        with pytest.raises(Overloaded):
            ctl.admit(1.0)
        assert ctl.stats()["admission_shed"] == 1

    def test_zero_loss_under_sustained_overload(self, tmpdir):
        """Producers submit 4x more than the watermark admits at once;
        a consumer steps the server concurrently.  Backpressure means
        every single request is eventually served — none lost, and the
        accounted queue cost never exceeds the high watermark."""
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, max_batch=8, admission=AdmissionConfig(
                high_watermark=16.0))
            ks = keys_n(64, "zl")
            db.put_many([(k, b"v") for k in ks])
            results = []
            res_lock = threading.Lock()

            def producer(chunk):
                for k in chunk:
                    r = srv.submit_get(k)
                    with res_lock:
                        results.append(r)

            threads = [threading.Thread(target=producer,
                                        args=(ks[i::4],), daemon=True)
                       for i in range(4)]
            for t in threads:
                t.start()
            served = 0
            while served < len(ks):
                served += srv.step()
                assert srv.admission.stats()["admission_peak_cost"] <= 16.0
            for t in threads:
                t.join(5.0)
            assert len(results) == 64           # zero requests lost
            assert all(r.done and r.value == b"v" for r in results)
            assert srv.stats()["admission_shed"] == 0

    def test_release_is_per_stage_not_per_step(self, tmpdir):
        """A mixed read/write step serves in stages; cost must drain as
        stages retire so waiters wake as soon as room exists."""
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=100.0))
            k = keys_n(1)[0]
            srv.submit_put(k, b"v")
            srv.submit_get(k)
            assert srv.stats()["admission_queued_cost"] > 0
            srv.step()
            assert srv.stats()["admission_queued_cost"] == pytest.approx(0.0)


# ------------------------------------------------------------- integration
class TestServerIntegration:
    def test_server_without_admission_is_unbounded(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db)
            for k in keys_n(100):
                srv.submit_get(k)               # never raises, never blocks
            assert len(srv.queue) == 100
            assert "admission_admitted" not in srv.stats()

    def test_admission_config_object_or_controller(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            srv1 = KvBatchServer(db, admission=AdmissionConfig())
            assert isinstance(srv1.admission, AdmissionController)
            ctl = AdmissionController(AdmissionConfig())
            srv2 = KvBatchServer(db, admission=ctl)
            assert srv2.admission is ctl

    def test_serve_failure_releases_cost_and_fails_only_its_stage(self,
                                                                  tmpdir):
        """A raising serve stage must not leak its admission budget (a leak
        permanently shrinks capacity) nor hang its submitters: the stage's
        requests complete with .error set, other stages still serve, and
        the queue budget drains back to zero."""
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=100.0))
            k = keys_n(1)[0]
            db.put(k, b"v")
            boom = RuntimeError("disk on fire")
            real = db.multi_get
            db.multi_get = lambda *a, **kw: (_ for _ in ()).throw(boom)
            failed = srv.submit_get(k)
            wrote = srv.submit_put(k, b"v2")    # separate (write) stage
            served = srv.step()
            db.multi_get = real
            assert served == 2                  # both drained and completed
            assert failed.done and failed.error is boom
            with pytest.raises(RuntimeError, match="disk on fire"):
                failed.result()
            assert wrote.done and wrote.error is None and wrote.pos is not None
            s = srv.stats()
            assert s["serve_errors"] == 1
            assert s["admission_queued_cost"] == pytest.approx(0.0)
            # the loop is not poisoned: the next request serves normally
            ok = srv.submit_get(k)
            srv.step()
            assert ok.result() == b"v2"

    def test_reserved_keyspace_write_rejected_at_submit(self, tmpdir):
        """A __system write must raise to the submitter BEFORE admission
        charges or the queue grows — reaching step() would fail the whole
        drained stage for every other client."""
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=8.0))
            with pytest.raises(ValueError, match="read-only"):
                srv.submit_put(b"k" * 16, b"v", keyspace="__system")
            with pytest.raises(ValueError, match="read-only"):
                srv.submit_delete(b"k" * 16, keyspace="__system")
            assert len(srv.queue) == 0
            assert srv.stats()["admission_queued_cost"] == pytest.approx(0.0)
            # reads of the reserved keyspace remain allowed
            srv.submit_get(b"k" * 16, keyspace="__system")
            srv.step()

    def test_close_fails_queued_requests_and_releases_cost(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=8.0, policy="shed"))
            reqs = [srv.submit_get(k) for k in keys_n(5)]
            assert srv.stats()["admission_queued_cost"] > 0
            assert srv.close() == 5
            assert srv.stats()["admission_queued_cost"] == pytest.approx(0.0)
            for r in reqs:
                assert r.done
                with pytest.raises(RuntimeError, match="closed"):
                    r.result()
            with pytest.raises(RuntimeError, match="closed"):
                srv.submit_get(keys_n(1, "late")[0])

    def test_stats_surface_admission_counters(self, tmpdir):
        with TideDB(tmpdir, small_cfg()) as db:
            srv = KvBatchServer(db, admission=AdmissionConfig(
                high_watermark=10.0, policy="shed"))
            for k in keys_n(5):
                srv.submit_exists(k)
            s = srv.stats()
            assert s["admission_admitted"] == 5
            assert s["admission_queued_cost"] == pytest.approx(2.5)
            srv.step()
            assert srv.stats()["admission_queued_cost"] == pytest.approx(0.0)
