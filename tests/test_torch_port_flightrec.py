"""The port's flight recorder, the engine's per-wave records and gen.*
lifecycle spans, against the JAX package's.

* ``utils/flightrec.FlightRecorder``: one record sequence under a
  scripted clock gives the same ring, ``stats()``, quantiles, ``since``
  slices and breach dumps (cooldown included) in both packages.
* The engine's records: the same submissions on the port's
  ``PagedEngine`` and the JAX engine (float32, one flax init, a pool
  tight enough to evict) give records with the same keys and the same
  values but the wall times, wave by wave; ``engine_stats(detail=True)``
  carries the ring; ``SELDON_TPU_FLIGHT_RECORDER=0`` keeps none;
  ``SELDON_TPU_DUMP_P99_MS`` dumps the ring to JSONL; the
  ``SELDON_TPU_PROFILE_DIR`` hook writes a ``torch.profiler`` Chrome
  trace of the first chunks.
* gen.* spans: with a tracer each stream emits the JAX engine's span
  sequence (queued, prefill, decode, finish; evict on an eviction) with
  the same tag keys, linked by trace id and parent span; an explicit
  ``trace_id`` wins; with no tracer there are none.
"""

import contextlib
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.utils import flightrec as jax_flightrec
from seldon_core_tpu.utils import tracing as jax_tracing
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.utils import flightrec, tracing

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=3, steps_per_call=4, num_pages=10, prefix_cache=False)
NEW = 14
WALL_KEYS = ("wall_ms", "prefill_wall_ms", "t", "seq")


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _records(n):
    rng = np.random.default_rng(1)
    return [{"phase": "decode", "wall_ms": float(w), "prefill_tokens": int(p), "decode_tokens": int(d),
             "queue_depth": int(q), "puids": [f"p{i}"]}
            for i, (w, p, d, q) in enumerate(zip(rng.uniform(1, 50, n), rng.integers(0, 9, n),
                                                 rng.integers(0, 30, n), rng.integers(0, 4, n)))]


def test_recorder_matches_jax(tmp_path):
    clocks = (_Clock(), _Clock())
    dirs = (tmp_path / "port", tmp_path / "jax")
    rings = [mod.FlightRecorder(capacity=8, dump_p99_ms=40.0, dump_dir=str(d), dump_cooldown_s=5.0, clock=c)
             for mod, d, c in zip((flightrec, jax_flightrec), dirs, clocks)]
    hooks = ([], [])
    for ring, hook in zip(rings, hooks):
        ring.on_dump = lambda recs, path, h=hook: h.append(([r["seq"] for r in recs], os.path.basename(path)))
    for rec in _records(30):
        for ring, clock in zip(rings, clocks):
            clock.t += 1.0
            ring.record(dict(rec))
    mine, theirs = rings
    assert mine.snapshot() == theirs.snapshot() and mine.stats() == theirs.stats()
    assert mine.since(25) == theirs.since(25)
    assert [mine.quantile_ms(q) for q in (0.5, 0.9, 0.99)] == [theirs.quantile_ms(q) for q in (0.5, 0.9, 0.99)]
    assert hooks[0] == hooks[1] and mine.dumps == theirs.dumps > 0
    for a, b in zip(sorted(os.listdir(dirs[0])), sorted(os.listdir(dirs[1]))):
        assert a == b and (dirs[0] / a).read_text() == (dirs[1] / b).read_text()


# ---------------------------------------------------------------------------
# the engine's records
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (17, 9, 30, 12, 21)]


def _drive(eng, trace=False):
    streams = [eng.submit(p, max_new_tokens=NEW, seed=i, puid=f"req-{i}",
                          **({"trace_id": f"trace-{i}", "parent_span_id": f"span-{i}"} if trace else {}))
               for i, p in enumerate(_prompts())]
    eng.run()
    return streams


@pytest.fixture(scope="module")
def record_runs(params, flax_params):
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    mine, theirs = _drive(port), _drive(jax_eng)
    return {"port": (port, mine), "jax": (jax_eng, theirs)}


def test_engine_records_equal_the_jax_engines(record_runs):
    (port, mine), (jax_eng, theirs) = record_runs["port"], record_runs["jax"]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.result, b.result)
    got = port.engine_stats(detail=True)["recorder"]
    want = jax_eng.engine_stats(detail=True)["recorder"]
    assert len(got) == len(want) > 0
    assert port.engine_stats()["evictions"] == jax_eng.engine_stats()["evictions"] > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k not in WALL_KEYS} == {k: v for k, v in w.items() if k not in WALL_KEYS}
    stats = port.engine_stats(detail=True)["recorder_stats"]
    assert stats["records"] == len(got) and stats["total_decode_tokens"] == port.engine_stats()["tokens"]
    assert stats["total_prefill_tokens"] == port.engine_stats()["prefill_tokens"]


def test_recorder_off_and_capacity(params):
    with _env(SELDON_TPU_FLIGHT_RECORDER="0"):
        off = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    with _env(SELDON_TPU_FLIGHT_RECORDER="3"):
        small = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    for eng in (off, small):
        _drive(eng)
    assert off.recorder is None
    detail = off.engine_stats(detail=True)
    assert detail["recorder"] == [] and detail["recorder_stats"] == {"records": 0, "seq": 0}
    assert small.recorder.capacity == 3 and len(small.engine_stats(detail=True)["recorder"]) == 3


def test_p99_breach_dumps_the_ring(params, tmp_path):
    with _env(SELDON_TPU_DUMP_P99_MS="0.000001", SELDON_TPU_DUMP_DIR=str(tmp_path)):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    _drive(eng)
    dumps = glob.glob(str(tmp_path / "flightrec-*.jsonl"))
    assert dumps and eng.recorder.dumps == len(dumps)  # one a cooldown window
    lines = [json.loads(line) for line in open(dumps[0])]
    assert lines and all(rec["phase"] in ("decode", "prefill") for rec in lines)


def test_profile_hook_writes_a_chrome_trace(params, tmp_path):
    with _env(SELDON_TPU_PROFILE_DIR=str(tmp_path), SELDON_TPU_PROFILE_CHUNKS="2"):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    eng.generate(_prompts()[0], max_new_tokens=12)
    traces = glob.glob(str(tmp_path / "paged-chunks-*.json"))
    assert len(traces) == 1 and json.load(open(traces[0]))["traceEvents"]
    assert eng._profiler is None and eng._profile_chunks_left == 0


# ---------------------------------------------------------------------------
# gen.* spans
# ---------------------------------------------------------------------------

def _span_shape(spans):
    """{trace id: [(name, parent span id, sorted tag keys), ...]} in order."""
    out = {}
    for s in sorted(spans, key=lambda s: (s.start_s, s.name)):
        out.setdefault(s.trace_id, []).append((s.name, s.parent_span_id, tuple(sorted(s.tags))))
    return out


@pytest.fixture
def tracers():
    before = (tracing._tracer, jax_tracing._tracer)
    mine, theirs = tracing.setup_tracing("port"), jax_tracing.setup_tracing("jax")
    yield mine, theirs
    tracing._tracer, jax_tracing._tracer = before


def test_gen_spans_match_the_jax_engines(params, flax_params, tracers):
    mine, theirs = tracers
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    _drive(port, trace=True)
    _drive(jax_eng, trace=True)
    got, want = _span_shape(mine.spans), _span_shape(theirs.spans)
    assert got.keys() == want.keys() == {f"trace-{i}" for i in range(5)}
    for tid in got:
        names = [n for n, _p, _t in got[tid]]
        assert [n for n, _p, _t in want[tid]] == names
        assert names[-1] == "gen.finish" and {"gen.queued", "gen.prefill", "gen.decode"} <= set(names)
        assert all(p == f"span-{tid.split('-')[1]}" for _n, p, _t in got[tid])
        assert [t for _n, _p, t in got[tid]] == [t for _n, _p, t in want[tid]]
    assert any("gen.evict" in [n for n, _p, _t in v] for v in got.values())  # the tight pool evicted


def test_spans_take_the_callers_span_and_cost_nothing_without_a_tracer(params):
    eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    before = tracing._tracer
    tracing._tracer = None
    try:
        st = eng.submit(_prompts()[0], max_new_tokens=4, puid="no-tracer")
        eng.run()
        assert st.trace_id == "" and st.puid == "no-tracer"
        tracer = tracing.setup_tracing("port")
        with tracer.span("request", trace_id="req-puid") as outer:
            st = eng.submit(_prompts()[0], max_new_tokens=4)
        eng.run()
        assert (st.trace_id, st.parent_span_id) == ("req-puid", outer.span_id)
        names = [s.name for s in tracer.find("req-puid")]
        assert names[0] == "request" and names[-1] == "gen.finish"
    finally:
        tracing._tracer = before
