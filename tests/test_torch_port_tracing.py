"""The port's tracing against the JAX package's.

``seldon_core_tpu_torch/utils/tracing.py`` and
``seldon_core_tpu/utils/tracing.py`` put the same identity on the wire:
``w3c_trace_id``, ``traceparent`` / ``tracestate`` (with the
``seldon-tpu`` vendor key) and the OTLP/HTTP JSON payload are equal byte
for byte for the same spans, and a context injected by either package
extracts to the same ``SpanContext`` in the other.  The tracer itself:
parent linkage, adoption of a remote caller's trace id, the ring's
``find`` by puid, the JSONL sink, the OTLP exporter against a loopback
sink (every socket with its own timeout), and the urandom-seeded id
PRNG's pid guard.
"""

import http.server
import json
import random
import re
import threading
import uuid

import pytest

from seldon_core_tpu.utils import tracing as jax_tracing
from seldon_core_tpu_torch.utils import tracing

LOGICAL_IDS = ["", "abc", "0123456789abcdef0123456789abcdef", "0123456789ABCDEF0123456789ABCDEF",
               "f" * 31, "puid-" + "x" * 40, "caffè"]


@pytest.fixture
def tracer(tmp_path):
    """A global tracer for one test, closed and uninstalled after it
    (the servers read the global: no other test may see it)."""
    t = tracing.setup_tracing(service_name="port-test", export_path=str(tmp_path / "spans.jsonl"))
    yield t
    t.close()
    tracing._tracer = None


@pytest.mark.parametrize("tid", LOGICAL_IDS)
def test_w3c_trace_id_equals_jax(tid):
    assert tracing.w3c_trace_id(tid) == jax_tracing.w3c_trace_id(tid)


@pytest.mark.parametrize("sampled", [True, False])
@pytest.mark.parametrize("state", ["", "vendor=1,other=2", "seldon-tpu=stale,vendor=1", " , x=y"])
def test_traceparent_and_tracestate_equal_jax(sampled, state):
    kw = dict(trace_id="puid-123", span_id="00f067aa0ba902b7", sampled=sampled, tracestate=state)
    ours, theirs = tracing.SpanContext(**kw), jax_tracing.SpanContext(**kw)
    assert ours.to_traceparent() == theirs.to_traceparent()
    assert ours.to_tracestate() == theirs.to_tracestate()
    assert ours.hex_trace_id == theirs.hex_trace_id


def _span_pair(trace_id="puid-7", span_id="0123456789abcdef", parent="fedcba9876543210"):
    kw = dict(trace_id=trace_id, name="node.m.transform_input", start_s=1_700_000_000.25, duration_s=0.0125,
              tags={"unit_type": "MODEL", "rows": 3}, parent="predictor.predict", span_id=span_id,
              parent_span_id=parent)
    return tracing.Span(**kw), jax_tracing.Span(**kw)


def test_inject_extract_cross_the_packages():
    ours, theirs = _span_pair()
    for inject_mod, span, extract_mod in ((tracing, ours, jax_tracing), (jax_tracing, theirs, tracing)):
        headers = inject_mod.inject({}, span=span)
        md = inject_mod.inject_metadata([("k", "v")], span=span)
        assert headers == {k: v for k, v in md if k != "k"}
        a, b = extract_mod.extract(headers), extract_mod.extract(md)
        assert a == b and a.trace_id == "puid-7" and a.span_id == "0123456789abcdef"
        assert tracing.extract(headers) == tracing.SpanContext(**jax_tracing.extract(headers).__dict__)
    assert tracing.inject({}, span=ours) == jax_tracing.inject({}, span=theirs)


@pytest.mark.parametrize("bad", [
    {"traceparent": "garbage"},
    {"traceparent": "ff-0123456789abcdef0123456789abcdef-0123456789abcdef-01"},
    {"traceparent": "00-" + "0" * 32 + "-0123456789abcdef-01"},
    {"traceparent": "00-0123456789abcdef0123456789abcdef-" + "0" * 16 + "-01"},
    {"Traceparent": "00-0123456789abcdef0123456789abcdef-0123456789abcdef-00", "tracestate": "a=b"},
    [("traceparent", "00-0123456789abcdef0123456789abcdef-0123456789abcdef-01"),
     ("tracestate", "seldon-tpu=logical,z=1")],
    None,
])
def test_extract_equals_jax_on_odd_carriers(bad):
    ours, theirs = tracing.extract(bad), jax_tracing.extract(bad)
    assert (ours is None) == (theirs is None)
    if ours is not None:
        assert ours.__dict__ == theirs.__dict__


def test_otlp_payload_equals_jax_byte_for_byte():
    pairs = [_span_pair(), _span_pair(trace_id="0123456789abcdef0123456789abcdef", parent=None),
             _span_pair(trace_id="caffè", span_id="1111222233334444")]
    ours = tracing.OtlpHttpExporter(endpoint="http://127.0.0.1:9/v1/traces", service_name="svc", timeout_s=1.0)
    theirs = jax_tracing.OtlpHttpExporter(endpoint="http://127.0.0.1:9/v1/traces", service_name="svc",
                                          timeout_s=1.0)
    try:
        a = json.dumps(ours.payload([p[0] for p in pairs]))
        b = json.dumps(theirs.payload([p[1] for p in pairs]))
        assert a == b
    finally:
        ours.close()
        theirs.close()


class _Sink(http.server.BaseHTTPRequestHandler):
    bodies: list = []

    def do_POST(self):  # noqa: N802 — http.server's name
        n = int(self.headers.get("Content-Length", 0))
        _Sink.bodies.append((self.path, self.rfile.read(n)))
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


def test_otlp_exporter_ships_the_same_bytes_as_jax():
    _Sink.bodies = []
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Sink)
    srv.timeout = 5
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    endpoint = f"http://127.0.0.1:{srv.server_address[1]}/v1/traces"
    try:
        for mod, idx in ((tracing, 0), (jax_tracing, 1)):
            exp = mod.OtlpHttpExporter(endpoint=endpoint, service_name="svc", batch_size=2, timeout_s=5.0)
            for s in (_span_pair()[idx], _span_pair(span_id="aaaabbbbccccdddd")[idx]):
                exp(s)  # the second fills the batch: shipped by the worker
            exp.close()
            assert exp.exported == 2 and exp.failures == 0
    finally:
        srv.shutdown()
        srv.server_close()
    assert [p for p, _ in _Sink.bodies] == ["/v1/traces"] * 2
    assert _Sink.bodies[0][1] == _Sink.bodies[1][1]


def test_tracer_links_children_and_adopts_a_remote_trace(tracer, tmp_path):
    ctx = tracing.extract({"traceparent": "00-0af7651916cd43dd8448eb211c80319c-b7ad6b7169203331-01"})
    with tracing.activate_context(ctx):
        with tracing.maybe_span("predictor.predict", trace_id="puid-local") as root:
            with tracing.maybe_span("node.m.transform_input", trace_id="puid-local") as child:
                assert tracing.current_span() is child
                md = tracing.inject_metadata()
    assert root.trace_id == child.trace_id == "0af7651916cd43dd8448eb211c80319c"  # the caller owns the trace
    assert root.parent_span_id == "b7ad6b7169203331" and child.parent_span_id == root.span_id
    assert child.parent == "predictor.predict" and root.tags["puid"] == "puid-local"
    assert dict(md)["traceparent"] == f"00-0af7651916cd43dd8448eb211c80319c-{child.span_id}-01"
    assert {s.name for s in tracer.find("puid-local")} == {"predictor.predict", "node.m.transform_input"}
    rows = [json.loads(line) for line in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [r["name"] for r in rows] == ["node.m.transform_input", "predictor.predict"]
    assert rows[0]["parentSpanId"] == root.span_id and rows[1]["parentSpanId"] == "b7ad6b7169203331"
    assert rows == [s.to_dict() for s in (child, root)]
    assert tracing.record_span("decode", "t", 1.0, 0.5, parent_span_id="p").parent_span_id == "p"


def test_no_tracer_costs_nothing():
    assert tracing.get_tracer() is None
    with tracing.maybe_span("x") as s:
        assert s is None and tracing.current_span() is None
    assert tracing.record_span("x", "t", 0.0, 0.0) is None
    assert tracing.inject({}) == {} and tracing.inject_metadata() == []


def test_ids_are_hex_and_reseed_when_the_pid_changes(monkeypatch):
    """The pid guard: a process whose pid differs from the one that
    seeded the stream (a forked child) reseeds from uuid4 before its
    first id, the same rule and the same ids as the JAX package's."""
    ids = {tracing._new_id(8) for _ in range(1000)}
    assert len(ids) == 1000 and all(re.fullmatch(r"[0-9a-f]{16}", i) for i in ids)
    assert re.fullmatch(r"[0-9a-f]{32}", tracing._new_id(16))
    seed = uuid.UUID(int=0x5E1D0)
    got = []
    for mod in (tracing, jax_tracing):
        monkeypatch.setattr(mod.uuid, "uuid4", lambda: seed)
        monkeypatch.setattr(mod.os, "getpid", lambda: -7)  # not the pid that seeded the stream
        got.append((mod._new_id(8), mod._new_id(16)))
        assert mod._ids_pid == -7
        monkeypatch.undo()
    rng = random.Random(seed.int)
    assert got[0] == got[1] == (f"{rng.getrandbits(64):016x}", f"{rng.getrandbits(128):032x}")
