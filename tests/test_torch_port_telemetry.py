"""The port's telemetry plane against the JAX package's: the telemetry
ring, the cost ledger, the Prometheus bridge and the OpenMetrics scrape.

* ``utils/telemetry.py``: a snapshot from either package validates in
  both (a future schema is refused by both); ``saturation_score`` agrees;
  a ``TelemetryRing`` under a scripted clock turns cumulative counters
  into the same rates.
* The cost ledger: the same mixed-adapter submissions on the port's
  ``PagedEngine`` and the JAX engine (float32, one flax init, a pool
  that evicts) under one scripted ``_cost_clock`` give equal
  ``cost_page_seconds`` and token totals, and equal per-adapter splits,
  each summing exactly to the totals; a preempted stream's
  preemptions and restores are counted; ``SELDON_TPU_TELEMETRY=0``
  sheds the ``cost_*`` keys.
* ``GenerationPrometheusBridge``: every port ``engine_stats()`` key (on
  every lane) is mapped or excluded, under the JAX package's canonical
  names and kinds where the keys are shared; counters are exported as
  deltas and re-base on a reset; the chunk-duration histogram counts
  each record once, by seq, with the wave's trace as its exemplar;
  ``collect()`` never raises; the off lane exports no cost series.
* The OpenMetrics 1.0 rendering parses with ``prometheus_client``'s
  parser and carries the exemplar; the text format 0.0.4 carries none.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.utils import metrics as jax_metrics
from seldon_core_tpu.utils import telemetry as jax_telemetry
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.ops import lora
from seldon_core_tpu_torch.utils import metrics, telemetry, tracing

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=3, steps_per_call=4, num_pages=10, prefix_cache=False)
RANK = 2
NEW = 14
MIX = ["t1", None, "t0", "t1", None]


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


# ---------------------------------------------------------------------------
# the ring and its schema
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 500.0

    def __call__(self):
        return self.t


class _FakeEngine:
    """Just what ``sample_engine`` reads, with cumulative counters."""

    max_slots = 4
    recorder = None

    def __init__(self, queued_key, active_key):
        self.n = 0
        self.keys = (queued_key, active_key)

    def engine_stats(self):
        self.n += 1
        q, a = self.keys
        return {q: self.n, a: 2, "tokens": 40 * self.n, "prefill_tokens": 100 * self.n, "completed": 3 * self.n,
                "shed": self.n, "prefix_hits": 3, "prefix_misses": 1, "pool_pages_used": 9, "pool_pages_total": 12,
                "cost_page_seconds": 1.5 * self.n, "health": "healthy", "kv_tier_host_bytes": 7,
                "kv_tier_host_hits": 2, "kv_tier_misses": 2}

    def adapter_stats(self):
        return {"resident": [{"name": "b"}, {"name": "a"}]}

    def predict_cost_s(self, prompt_len, max_new):
        return 0.25


def test_ring_rates_and_schema_match_jax():
    clocks = (_Clock(), _Clock())
    rings = (telemetry.TelemetryRing("r1", capacity=4, clock=clocks[0]),
             jax_telemetry.TelemetryRing("r1", capacity=4, clock=clocks[1]))
    # the port's engine names its occupancy keys active / queued
    engines = (_FakeEngine("queued", "active"), _FakeEngine("queued_streams", "active_slots"))
    for _ in range(6):
        for ring, clock, eng in zip(rings, clocks, engines):
            clock.t += 2.0
            ring.sample_engine(eng)
    mine, theirs = (r.snapshot(window_s=5.0) for r in rings)
    assert mine == theirs and len(mine["points"]) == 3
    assert mine["latest"]["goodput_tok_s"] == 20.0 and mine["latest"]["saturation"] == 0.75
    for snap in (mine, theirs):
        telemetry.validate_snapshot(snap)
        jax_telemetry.validate_snapshot(snap)
    future = dict(mine, schema_version=telemetry.TELEMETRY_SCHEMA_VERSION + 1)
    for mod in (telemetry, jax_telemetry):
        with pytest.raises(mod.SchemaVersionError):
            mod.validate_snapshot(future)
        with pytest.raises(ValueError):
            mod.validate_snapshot({"points": []})
    point = {"pool_pages_used": 3, "pool_pages_total": 10, "queue_depth": 9, "active_slots_total": 4}
    assert telemetry.saturation_score(point) == jax_telemetry.saturation_score(point)


# ---------------------------------------------------------------------------
# the cost ledger
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _adapters():
    return {f"t{i}": lora.make_lora_params(100 + i, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=RANK)
            for i in range(2)}


def _registry(mod):
    reg = mod.WeightRegistry(budget_bytes=0)
    for name, ad in _adapters().items():
        reg.register(name, (lambda a=ad: a), bytes_hint=lora.adapter_bytes(ad))
    return reg


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (17, 9, 30, 12, 21)]


def _ledger_run(eng):
    """The mix with a scripted clock that advances one second a wave,
    plus a priority-2 submit that preempts; returns the streams."""
    t = [100.0]
    eng._cost_clock = lambda: t[0]
    streams = [eng.submit(p, max_new_tokens=NEW, adapter=a) for p, a in zip(_prompts(), MIX)]
    waves = 0
    while eng.has_work():
        eng.step()
        t[0] += 1.0
        waves += 1
        if waves == 3:
            streams.append(eng.submit(_prompts()[0], max_new_tokens=6, priority=2))
    return streams


@pytest.fixture(scope="module")
def ledgers(params, flax_params):
    with _env(SELDON_TPU_PAGED_KERNEL="force", SELDON_TPU_CHUNK_IMPL="pool"):
        port = PagedEngine(params, dtype="float32", device="cpu", max_adapters=2, lora_rank=RANK,
                           weight_registry=_registry(registry), **CFG, **ENGINE)
        jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, max_adapters=2, lora_rank=RANK,
                                        weight_registry=_registry(jax_registry), **CFG, **ENGINE)
        return (port, _ledger_run(port)), (jax_eng, _ledger_run(jax_eng))


def test_cost_ledger_equals_the_jax_engines(ledgers):
    (port, mine), (jax_eng, theirs) = ledgers
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.result, b.result)
    got, want = port.engine_stats(), jax_eng.engine_stats()
    assert got["evictions"] == want["evictions"] > 0 and got["preempted"] == want["preempted"] > 0
    for key in ("cost_page_seconds", "cost_prefill_tokens", "cost_decode_tokens"):
        assert got[key] == want[key], key
    assert got["cost_by_adapter"] == want["cost_by_adapter"]
    assert got["cost_page_seconds"] > 0
    for (a, b) in zip(mine, theirs):
        assert (a.cost_page_s, a.cost_prefill_tokens, a.cost_decode_tokens, a.cost_preempts, a.cost_restores) == (
            b.cost_page_s, b.cost_prefill_tokens, b.cost_decode_tokens, b.cost_preempts, b.cost_restores)
    assert sum(s.cost_preempts for s in mine) == got["preempted"] and sum(s.cost_restores for s in mine) > 0


def test_adapter_split_sums_exactly_to_the_totals(ledgers):
    (port, _mine), _ = ledgers
    stats = port.engine_stats()
    split = stats["cost_by_adapter"]
    assert set(split) == {"base", "t0", "t1"}
    assert sum(v["page_seconds"] for v in split.values()) == stats["cost_page_seconds"]
    assert sum(v["prefill_tokens"] for v in split.values()) == stats["cost_prefill_tokens"]
    assert sum(v["decode_tokens"] for v in split.values()) == stats["cost_decode_tokens"]
    assert sum(v["streams"] for v in split.values()) == stats["completed"]


def test_telemetry_off_sheds_the_cost_keys(params):
    with _env(SELDON_TPU_TELEMETRY="0"):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    eng.generate(_prompts()[0], max_new_tokens=4)
    stats = eng.engine_stats()
    assert not any(k.startswith("cost_") for k in stats)


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _lanes(params):
    """engine_stats() keys of every lane: defaults, the KV tier and capture
    on, and everything off."""
    keys = set()
    for env in ({}, {"SELDON_TPU_KV_OFFLOAD": "1", "SELDON_TPU_CAPTURE": "1"},
                {"SELDON_TPU_TELEMETRY": "0", "SELDON_TPU_WATCHDOG": "0", "SELDON_TPU_FLIGHT_RECORDER": "0"}):
        with _env(**env):
            eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
        eng.generate(_prompts()[1], max_new_tokens=4)
        keys |= set(eng.engine_stats())
    return keys


def test_every_stats_key_is_mapped_or_excluded(params):
    keys = _lanes(params)
    mapped, excluded = set(metrics.ENGINE_STATS_METRICS), metrics.ENGINE_STATS_EXCLUDED
    assert keys <= mapped | excluded, sorted(keys - mapped - excluded)
    assert not mapped & excluded
    for key in mapped & set(jax_metrics.ENGINE_STATS_METRICS):
        assert metrics.ENGINE_STATS_METRICS[key][:2] == jax_metrics.ENGINE_STATS_METRICS[key][:2], key
    # the port's occupancy keys under the JAX names of active_slots / queued_streams
    assert metrics.ENGINE_STATS_METRICS["active"][1] == jax_metrics.ENGINE_STATS_METRICS["active_slots"][1]
    assert metrics.ENGINE_STATS_METRICS["queued"][1] == jax_metrics.ENGINE_STATS_METRICS["queued_streams"][1]
    assert metrics.COST_LEDGER_METRICS == jax_metrics.COST_LEDGER_METRICS
    assert metrics.CHUNK_DURATION_METRIC == jax_metrics.CHUNK_DURATION_METRIC


def _series(reg, name, **labels):
    out = {}
    for fam, _kind, _doc, samples in reg.collect():
        for sample in samples:
            s_name, s_labels, value = sample[:3]
            lab = dict(s_labels)
            if s_name == name and all(lab.get(k) == v for k, v in labels.items()):
                out[tuple(sorted(lab.items()))] = value
    return out


def test_bridge_deltas_histogram_and_exemplars(params):
    reg = metrics.Registry()
    before = tracing._tracer
    tracing.setup_tracing("bridge")
    try:
        eng = PagedEngine(params, dtype="float32", device="cpu", max_adapters=2, lora_rank=RANK,
                          weight_registry=_registry(registry), **CFG, **ENGINE)
        bridge = metrics.GenerationPrometheusBridge(eng, model_name="m", registry=reg)
        eng.submit(_prompts()[0], max_new_tokens=8, adapter="t0", trace_id="trace-x")
        eng.run()
        bridge.collect()
        bridge.collect()  # a second collect adds nothing
    finally:
        tracing._tracer = before
    stats = eng.engine_stats()
    (tokens,) = _series(reg, "seldon_tpu_engine_tokens_total", model_name="m").values()
    (count,) = _series(reg, "seldon_tpu_engine_chunk_duration_seconds_count", model_name="m").values()
    assert tokens == stats["tokens"] and count == len(eng.recorder.snapshot()) == stats["chunks"]
    assert _series(reg, "seldon_tpu_engine_adapter_requests_total", adapter="t0") == {
        tuple(sorted({"adapter": "t0", "deployment_name": "", "model_name": "m", "predictor_name": ""}.items())): 1.0}
    (page_s,) = _series(reg, "seldon_tpu_engine_cost_adapter_page_seconds_total", adapter="t0").values()
    assert page_s == stats["cost_by_adapter"]["t0"]["page_seconds"]
    # a counter that went backwards (a replaced engine) re-bases, never subtracts
    eng._counters["tokens"] = 3
    bridge.collect()
    (tokens,) = _series(reg, "seldon_tpu_engine_tokens_total", model_name="m").values()
    assert tokens == stats["tokens"] + 3
    om = metrics.generate_latest(reg, openmetrics=True).decode()
    plain = metrics.generate_latest(reg).decode()
    assert '# {trace_id="trace-x"}' in om and om.endswith("# EOF\n") and "trace_id" not in plain
    from prometheus_client.openmetrics.parser import text_string_to_metric_families

    families = {f.name: f for f in text_string_to_metric_families(om)}
    hist = families["seldon_tpu_engine_chunk_duration_seconds"]
    assert any(s.exemplar is not None and s.exemplar.labels == {"trace_id": "trace-x"} for s in hist.samples)
    assert families["seldon_tpu_engine_tokens"].type == "counter"


def test_bridge_collect_never_raises_and_the_off_lane_exports_no_cost(params):
    class Broken:
        recorder = None

        def engine_stats(self):
            raise RuntimeError("engine gone")

    metrics.GenerationPrometheusBridge(Broken(), registry=metrics.Registry()).collect()
    reg = metrics.Registry()
    with _env(SELDON_TPU_TELEMETRY="0"):
        eng = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    eng.generate(_prompts()[0], max_new_tokens=4)
    metrics.GenerationPrometheusBridge(eng, registry=reg).collect()
    names = {fam for fam, *_rest in reg.collect()}
    assert "seldon_tpu_engine_tokens_total" in names
    assert not any("cost" in name for name in names)
