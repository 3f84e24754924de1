"""Request logging and persistence in the port, against the JAX package.

The mirror of ``tests/test_observability.py``'s logger, consumer,
pair-stamping and Kafka classes on the port's ``utils/reqlogger.py``,
``utils/reqconsumer.py`` and ``utils/kafka.py``: a served pair is logged
once on the async and the sync path, indexed and found by puid; the
``traceparent`` of a pair is the JAX package's for the same puid; the
HTTP sink posts CloudEvents over ``urllib`` to the consumer; the Kafka
producer's message sets are the JAX package's bytes and land on a fake
broker that decodes them on its own.  Then ``utils/persistence.py``: the
routers' and ``RANDOM_ABTEST``'s state round-trips through a snapshot,
which either package restores; the microservice's ``--persistence``
flags; ``get_feature_names``.
"""

import asyncio
import json
import re
import socket
import struct
import threading
import time
import zlib

import numpy as np
import pytest

from seldon_core_tpu.components import routers as jax_routers
from seldon_core_tpu.runtime.message import InternalMessage as JaxInternalMessage
from seldon_core_tpu.utils import kafka as jax_kafka
from seldon_core_tpu.utils import persistence as jax_persistence
from seldon_core_tpu.utils import reqlogger as jax_reqlogger
from seldon_core_tpu_torch.components.routers import EpsilonGreedy, ThompsonSampling
from seldon_core_tpu_torch.engine import units
from seldon_core_tpu_torch.engine.graph import UnitSpec
from seldon_core_tpu_torch.engine.server import Gateway
from seldon_core_tpu_torch.engine.service import PredictorService
from seldon_core_tpu_torch.runtime import microservice
from seldon_core_tpu_torch.runtime.component import TPUComponent, get_feature_names
from seldon_core_tpu_torch.runtime.message import InternalMessage
from seldon_core_tpu_torch.utils import tracing
from seldon_core_tpu_torch.utils.kafka import MiniKafkaProducer, decode_message_set, encode_message_set
from seldon_core_tpu_torch.utils.persistence import PersistenceManager
from seldon_core_tpu_torch.utils.reqconsumer import PairIndex, build_consumer_app
from seldon_core_tpu_torch.utils.reqlogger import HttpPairLogger, JsonlPairLogger, KafkaPairLogger, build_pair

TRACEPARENT = r"^00-[0-9a-f]{32}-[0-9a-f]{16}-01$"


def run(coro):
    return asyncio.run(coro)


def msg(arr, cls=InternalMessage):
    return cls(payload=np.asarray(arr, dtype=np.float64), kind="tensor")


class Doubler(TPUComponent):
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


def _service(**kw):
    return PredictorService(UnitSpec(name="m", type="MODEL", component=Doubler()), name="main", **kw)


class TestRequestLogger:
    def test_pair_logged_on_the_async_and_the_sync_path(self, tmp_path):
        path = str(tmp_path / "pairs.jsonl")
        svc = _service(request_logger=JsonlPairLogger(path))
        a = run(svc.predict(msg([[3.0]])))
        b = svc.predict_sync(msg([[4.0]]))
        pairs = [json.loads(line) for line in open(path)]
        assert [p["puid"] for p in pairs] == [a.meta.puid, b.meta.puid] and all(p["puid"] for p in pairs)
        assert pairs[0]["request"]["data"]["tensor"]["values"] == [3.0]
        assert pairs[0]["response"]["data"]["tensor"]["values"] == [6.0]
        assert pairs[1]["response"]["data"]["tensor"]["values"] == [8.0]

    def test_a_broken_sink_loses_the_pair_never_the_request(self):
        def broken(request, response):
            raise RuntimeError("sink down")

        out = run(_service(request_logger=broken).predict(msg([[1.0]])))
        assert out.status["code"] == 200 and out.payload is not None


class TestRequestLogConsumer:
    def test_predict_log_ingest_query_by_puid(self, tmp_path):
        path = str(tmp_path / "pairs.jsonl")
        out = run(_service(request_logger=JsonlPairLogger(path)).predict(msg([[3.0]])))
        index = PairIndex(str(tmp_path / "pairs.sqlite"))
        assert index.ingest_jsonl(path) == 1
        pair = index.get(out.meta.puid)
        assert pair["request"]["data"]["tensor"]["values"] == [3.0]
        assert pair["response"]["data"]["tensor"]["values"] == [6.0]
        assert index.get("no-such-puid") is None

    def test_http_pair_logger_to_consumer_e2e(self):
        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            index = PairIndex()
            client = TestClient(TestServer(build_consumer_app(index)))
            await client.start_server()
            svc = _service(request_logger=HttpPairLogger(f"http://127.0.0.1:{client.port}/"))
            out = await svc.predict(msg([[4.0]]))
            deadline = time.time() + 10.0
            while index.count() < 1 and time.time() < deadline:
                await asyncio.sleep(0.05)
            await svc.close()  # joins the logger's drain thread
            body = await (await client.get(f"/pairs/{out.meta.puid}")).json()
            listing = await (await client.get("/pairs", params={"limit": "10"})).json()
            stats = await (await client.get("/stats")).json()
            bad = await client.post("/", json={"puid": "x"}, headers={"CE-Type": "other"})
            await client.close()
            return body, listing, stats, bad.status, svc.request_logger._thread.is_alive()

        body, listing, stats, bad, alive = run(scenario())
        assert body["response"]["data"]["tensor"]["values"] == [8.0]
        assert listing["count"] == 1 and stats["pairs"] == 1 and bad == 400 and not alive

    def test_query_filters_and_upsert(self):
        index = PairIndex()
        for i, (puid, predictor) in enumerate([("p1", "main"), ("p2", "main"), ("p3", "canary")]):
            index.ingest({"puid": puid, "time": 100.0 + i, "request": {"data": {"ndarray": [[i]]}},
                          "response": {"meta": {"puid": puid, "tags": {"predictor": predictor}}}})
        assert index.count() == 3
        assert len(index.query(predictor="main", limit=10)) == 2
        assert len(index.query(since=101.5, limit=10)) == 1
        index.ingest({"puid": "p1", "time": 200.0, "request": {}, "response": {"meta": {"puid": "p1"}}})
        assert index.count() == 3 and index.get("p1")["time"] == 200.0
        with pytest.raises(ValueError):
            index.ingest({"request": {}, "response": {}})

    def test_cli_ingest_and_query(self, tmp_path, capsys):
        from seldon_core_tpu_torch.utils.reqconsumer import main

        path = tmp_path / "pairs.jsonl"
        path.write_text(json.dumps({"puid": "q1", "time": 1.0, "request": {}, "response": {}}) + "\n")
        db = str(tmp_path / "db.sqlite")
        main(["--db", db, "ingest", str(path)])
        main(["--db", db, "query", "--puid", "q1"])
        out = capsys.readouterr().out
        assert "indexed 1 pairs" in out and '"puid": "q1"' in out


class TestPairStamping:
    @staticmethod
    def _pair(cls=InternalMessage, puid="puid-abc", cost=None):
        req, resp = msg([[1.0]], cls), msg([[2.0]], cls)
        resp.meta.puid = puid
        if cost is not None:
            resp.meta.tags["cost"] = cost
        return req, resp

    def test_traceparent_is_the_jax_packages_without_a_live_span(self):
        pair = build_pair(*self._pair())
        assert re.match(TRACEPARENT, pair["traceparent"])
        assert pair["traceparent"] == jax_reqlogger.build_pair(*self._pair(JaxInternalMessage))["traceparent"]
        assert build_pair(*self._pair(puid="puid-xyz"))["traceparent"] != pair["traceparent"]
        assert pair["request"] == jax_reqlogger.build_pair(*self._pair(JaxInternalMessage))["request"]

    def test_traceparent_uses_the_live_span_when_one_is_active(self):
        tracer = tracing.setup_tracing("pair-test")
        try:
            with tracer.span("op", trace_id="t-live") as span:
                pair = build_pair(*self._pair())
            assert pair["traceparent"] == f"00-{tracing.w3c_trace_id('t-live')}-{span.span_id}-01"
        finally:
            tracing._tracer = None

    def test_cost_totals_ride_the_pair(self):
        cost = {"page_seconds": 0.25, "decode_tokens": 8, "adapter": "base"}
        assert build_pair(*self._pair(cost=cost))["cost"] == cost
        assert "cost" not in build_pair(*self._pair())


class TestHttpPairLoggerDrainClose:
    def test_full_queue_drops_and_counts(self):
        lg = HttpPairLogger("http://127.0.0.1:9/", capacity=2)
        lg._queue.put(None)  # stop the drain thread so the queue fills
        lg._thread.join(timeout=5.0)
        req, resp = msg([[1.0]]), msg([[2.0]])
        for _ in range(4):
            lg(req, resp)
        assert lg.dropped == 2

    def test_dead_collector_never_raises_and_close_is_bounded(self):
        lg = HttpPairLogger("http://127.0.0.1:9/", capacity=8, timeout_s=0.2)
        req, resp = msg([[1.0]]), msg([[2.0]])
        for _ in range(3):
            lg(req, resp)
        t0 = time.monotonic()
        lg.close()
        assert time.monotonic() - t0 < 5.0 and not lg._thread.is_alive() and lg.dropped == 0


class _SilentEndpoint:
    """Accepts connections and never answers: every POST waits out its timeout."""

    def __init__(self):
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(64)
        self.port = self.sock.getsockname()[1]
        self.held = []
        self._thread = threading.Thread(target=self._accept, daemon=True)
        self._thread.start()

    def _accept(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self.held.append(conn)

    def close(self):
        self.sock.close()
        for conn in self.held:
            conn.close()


class TestHttpPairLoggerBoundedClose:
    """A full queue in front of an endpoint that never answers: close()
    returns within its timeout plus 1 s and counts what it gave up."""

    def _full_logger(self, endpoint, capacity=4):
        lg = HttpPairLogger(f"http://127.0.0.1:{endpoint.port}/", capacity=capacity, timeout_s=2.0)
        req, resp = msg([[1.0]]), msg([[2.0]])
        lg(req, resp)  # the drain thread takes this one into a POST that hangs
        deadline = time.monotonic() + 2.0
        while lg._queue.qsize() > 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        for _ in range(capacity):
            lg(req, resp)
        assert lg._queue.full()
        return lg

    def test_close_returns_within_its_timeout_and_counts_the_rest(self):
        endpoint = _SilentEndpoint()
        try:
            lg = self._full_logger(endpoint)
            t0 = time.monotonic()
            lg.close(timeout_s=0.5)
            assert time.monotonic() - t0 < 0.5 + 1.0
            lg._thread.join(timeout=10.0)  # the hung POST ends at its own 2 s timeout
            assert not lg._thread.is_alive() and lg.dropped == 4
        finally:
            endpoint.close()

    def test_gateway_close_is_bounded_with_it(self):
        endpoint = _SilentEndpoint()
        try:
            lg = self._full_logger(endpoint)
            gw = Gateway([(_service(), 1.0)], request_logger=lg)
            t0 = time.monotonic()
            run(gw.close())
            assert time.monotonic() - t0 < 5.0 + 1.0
        finally:
            endpoint.close()


class TestGatewayRequestLogger:
    def test_pairs_logged_after_finalize(self, tmp_path):
        path = str(tmp_path / "gw-pairs.jsonl")
        gw = Gateway([(_service(), 1.0)], request_logger=JsonlPairLogger(path))
        out = run(gw.predict(msg([[3.0]])))
        (pair,) = [json.loads(line) for line in open(path)]
        assert pair["puid"] == out.meta.puid
        assert pair["response"]["meta"]["tags"]["predictor"] == "main"
        assert re.match(TRACEPARENT, pair["traceparent"])

    def test_sink_failure_and_close(self):
        calls = []

        class Sink:
            closed = False

            def __call__(self, request, response):
                calls.append(1)
                raise RuntimeError("sink down")

            def close(self):
                self.closed = True

        sink = Sink()
        gw = Gateway([(_service(), 1.0)], request_logger=sink)
        out = run(gw.predict(msg([[3.0]])))
        assert calls == [1] and out.payload is not None
        run(gw.close())
        assert sink.closed


# ---------------------------------------------------------------------------
# Kafka
# ---------------------------------------------------------------------------

class FakeKafkaBroker:
    """A broker of Metadata v0 + Produce v0 over a real socket, decoding
    the frames on its own (struct-level, CRC checked)."""

    def __init__(self, partitions: int = 2):
        self.partitions = partitions
        self.records = []  # (topic, partition, key, value)
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(4)
        self.port = self._srv.getsockname()[1]
        self._running = True
        threading.Thread(target=self._serve, daemon=True).start()

    @staticmethod
    def _rd_str(buf, off):
        (n,) = struct.unpack_from(">h", buf, off)
        off += 2
        return (None, off) if n < 0 else (buf[off:off + n].decode(), off + n)

    @staticmethod
    def _wr_str(s):
        b = s.encode()
        return struct.pack(">h", len(b)) + b

    def _serve(self):
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    @staticmethod
    def _recv_exact(conn, n):
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                return None
            out += chunk
        return out

    def _handle(self, conn):
        try:
            while True:
                head = self._recv_exact(conn, 4)
                if head is None:
                    return
                payload = self._recv_exact(conn, struct.unpack(">i", head)[0])
                if payload is None:
                    return
                api_key, api_version, corr = struct.unpack_from(">hhi", payload, 0)
                _client, off = self._rd_str(payload, 8)
                assert api_version == 0
                resp = self._metadata(payload, off) if api_key == 3 else self._produce(payload, off)
                frame = struct.pack(">i", corr) + resp
                conn.sendall(struct.pack(">i", len(frame)) + frame)
        except (ConnectionError, OSError):
            return
        finally:
            conn.close()

    def _metadata(self, buf, off):
        (n_topics,) = struct.unpack_from(">i", buf, off)
        off += 4
        names = []
        for _ in range(n_topics):
            name, off = self._rd_str(buf, off)
            names.append(name)
        out = struct.pack(">i", 1) + struct.pack(">i", 0) + self._wr_str("127.0.0.1") + struct.pack(">i", self.port)
        out += struct.pack(">i", len(names))
        for name in names:
            parts = b"".join(struct.pack(">hii", 0, p, 0) + struct.pack(">ii", 1, 0) + struct.pack(">ii", 1, 0)
                             for p in range(self.partitions))
            out += struct.pack(">h", 0) + self._wr_str(name) + struct.pack(">i", self.partitions) + parts
        return out

    def _produce(self, buf, off):
        off += 6  # acks, timeout
        (n_topics,) = struct.unpack_from(">i", buf, off)
        off += 4
        resp = b""
        for _ in range(n_topics):
            topic, off = self._rd_str(buf, off)
            (n_parts,) = struct.unpack_from(">i", buf, off)
            off += 4
            parts = b""
            for _ in range(n_parts):
                partition, size = struct.unpack_from(">ii", buf, off)
                off += 8
                end, base = off + size, len(self.records)
                while off + 12 <= end:
                    _offset, msize = struct.unpack_from(">qi", buf, off)
                    off += 12
                    (crc,) = struct.unpack_from(">I", buf, off)
                    body = buf[off + 4:off + msize]
                    off += msize
                    assert zlib.crc32(body) & 0xFFFFFFFF == crc
                    (klen,) = struct.unpack_from(">i", body, 2)
                    p, key = 6, None
                    if klen >= 0:
                        key, p = body[p:p + klen], p + klen
                    (vlen,) = struct.unpack_from(">i", body, p)
                    self.records.append((topic, partition, key, body[p + 4:p + 4 + vlen]))
                parts += struct.pack(">ihq", partition, 0, base)
            resp += self._wr_str(topic) + struct.pack(">i", n_parts) + parts
        return struct.pack(">i", n_topics) + resp

    def close(self):
        self._running = False
        self._srv.close()


def _kafka_pair(puid="p-1"):
    req = InternalMessage(payload=np.asarray([[1.0, 2.0]]), kind="ndarray")
    req.meta.puid = puid
    return req, req.with_payload(np.asarray([[0.9]]))


class TestKafkaPairLogger:
    def test_message_sets_are_the_jax_packages_bytes(self):
        for key in (b"k", None):
            assert encode_message_set(key, b"v" * 100) == jax_kafka.encode_message_set(key, b"v" * 100)
        mset = encode_message_set(b"k", b"v" * 100)
        assert decode_message_set(mset) == [(b"k", b"v" * 100)]
        with pytest.raises(ValueError, match="CRC"):
            decode_message_set(mset[:-1] + bytes([mset[-1] ^ 0xFF]))

    def test_pairs_stream_to_topic_over_the_wire(self):
        broker = FakeKafkaBroker(partitions=2)
        try:
            lg = KafkaPairLogger(f"127.0.0.1:{broker.port}", topic="pairs")
            lg(*_kafka_pair())
            lg.close()
            assert lg.sent == 1 and lg.dropped == 0
            ((topic, partition, key, value),) = broker.records
            pair = json.loads(value)
            assert topic == "pairs" and 0 <= partition < 2 and key == b"p-1"
            assert pair["request"]["data"]["ndarray"] == [[1.0, 2.0]] and pair["puid"] == "p-1"
            assert pair["response"]["data"]["ndarray"] == [[0.9]]
        finally:
            broker.close()

    def test_puid_keys_pin_partition_and_close_flushes(self):
        broker = FakeKafkaBroker(partitions=4)
        try:
            lg = KafkaPairLogger(f"127.0.0.1:{broker.port}", topic="t")
            for _ in range(5):
                lg(*_kafka_pair("same-puid"))
            lg.close()
            assert lg.sent == 5 and len({p for (_, p, _, _) in broker.records}) == 1
        finally:
            broker.close()

    def test_bootstrap_falls_through_and_reconnects(self):
        broker = FakeKafkaBroker(partitions=1)
        try:
            p = MiniKafkaProducer(f"127.0.0.1:1,127.0.0.1:{broker.port}", timeout_s=1.0)
            assert p.send("t", b"one") == 0
            for sock in list(p._conns.values()):
                sock.close()
            p._conns.clear()
            assert p.send("t", b"two") >= 0
            assert [v for (_, _, _, v) in broker.records] == [b"one", b"two"]
            p.close()
        finally:
            broker.close()

    def test_broker_outage_is_counted_not_silent(self):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()  # nothing ever listens here
        lg = KafkaPairLogger(f"127.0.0.1:{port}", topic="t", timeout_s=0.5)
        lg(*_kafka_pair())
        lg.close()
        assert lg.failed == 1 and lg.sent == 0

    def test_close_is_bounded_with_full_queue_and_stuck_broker(self, monkeypatch):
        broker = FakeKafkaBroker(partitions=1)
        try:
            lg = KafkaPairLogger(f"127.0.0.1:{broker.port}", topic="t", capacity=1)
            monkeypatch.setattr(lg._producer, "send", lambda *a, **k: time.sleep(30))
            lg(*_kafka_pair())
            deadline = time.monotonic() + 2.0
            while lg._queue.qsize() > 0 and time.monotonic() < deadline:
                time.sleep(0.01)
            lg(*_kafka_pair())
            assert lg._queue.full()
            t0 = time.monotonic()
            lg.close(timeout_s=0.5)
            assert time.monotonic() - t0 < 5.0
        finally:
            broker.close()


# ---------------------------------------------------------------------------
# persistence
# ---------------------------------------------------------------------------

def _taught(router, rewards):
    for branch, reward in rewards:
        router.send_feedback(None, [], reward, None, routing=branch)
    return router


REWARDS = [(0, 1.0), (1, 0.0), (1, 1.0), (0, 1.0), (1, 0.25)]


class TestPersistence:
    @pytest.mark.parametrize("name", ["THOMPSON_SAMPLING", "EPSILON_GREEDY", "RANDOM_ABTEST"])
    def test_state_round_trips_through_a_snapshot(self, tmp_path, name):
        src = _taught(units.make_builtin(name, seed=1), REWARDS)
        manager = PersistenceManager(str(tmp_path), f"dep/pred.{name}")
        assert manager.path.endswith(f"dep_pred_{name}.json") and manager.save(src)
        dst = units.make_builtin(name, seed=1)
        assert manager.restore(dst)
        a, b = src.checkpoint_state(), dst.checkpoint_state()
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))

    @pytest.mark.parametrize("mine,theirs", [(ThompsonSampling, jax_routers.ThompsonSampling),
                                             (EpsilonGreedy, jax_routers.EpsilonGreedy)])
    def test_either_package_restores_the_others_snapshot(self, tmp_path, mine, theirs):
        ours = _taught(mine(seed=0), REWARDS)
        PersistenceManager(str(tmp_path), "a").save(ours)
        restored = theirs(seed=0)
        assert jax_persistence.PersistenceManager(str(tmp_path), "a").restore(restored)
        jax_persistence.PersistenceManager(str(tmp_path), "b").save(restored)
        back = mine(seed=0)
        assert PersistenceManager(str(tmp_path), "b").restore(back)
        for key, value in ours.checkpoint_state().items():
            np.testing.assert_array_equal(np.asarray(back.checkpoint_state()[key]), np.asarray(value))

    def test_nothing_to_save_and_a_corrupt_snapshot_starts_fresh(self, tmp_path):
        manager = PersistenceManager(str(tmp_path), "k")
        assert not manager.save(Doubler()) and not manager.restore(ThompsonSampling())
        with open(manager.path, "w") as f:
            f.write("{not json")
        router = ThompsonSampling()
        assert not manager.restore(router)
        np.testing.assert_array_equal(router.alpha, np.ones(2))

    def test_the_background_thread_snapshots_at_stop(self, tmp_path):
        router = ThompsonSampling(seed=0)
        manager = PersistenceManager(str(tmp_path), "bg")
        thread = manager.start_background(router, period_s=3600.0)
        _taught(router, REWARDS)
        thread.stop()
        thread.join(timeout=5)
        fresh = ThompsonSampling()
        assert manager.restore(fresh)
        np.testing.assert_array_equal(fresh.alpha, router.alpha)

    def test_the_microservice_flags(self, tmp_path):
        args = microservice.parse_args(["m.M", "--persistence", "--persistence-dir", str(tmp_path),
                                        "--persistence-period-s", "5"])
        assert args.persistence and args.persistence_dir == str(tmp_path) and args.persistence_period_s == 5.0
        assert microservice.parse_args(["m.M"]).persistence is False


def test_get_feature_names():
    class Named(TPUComponent):
        def feature_names(self):
            return ("a", "b")

    assert get_feature_names(Named()) == ["a", "b"]
    assert get_feature_names(Doubler()) == [] and get_feature_names(object()) == []
