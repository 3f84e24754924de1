"""The port's generation scheduler against the JAX engine's.

Three workloads run through the JAX engine (float32, the pool chunk, the
kernel lane forced: JAX's Pallas kernel in interpret mode) and the
port's, with the same submission order: greedy tokens equal and the
scheduler's counters equal —

* **pool pressure** — four streams in a pool of 8 usable pages under
  ``max_steps_per_call``: the stalls, the evictions and the ladder's
  chunk lengths (JAX's from its flight recorder), and the tokens those of
  an engine with the full pool;
* **chunked prefill** — ``chunk_token_budget=24`` over prompts of 5 to
  70 tokens: the prefill tokens and calls;
* **preemption** — a priority-5 arrival preempting a priority-0 stream
  for pages, which restores and re-derives its tokens.

Then the port versions of ``tests/test_slo_lifecycle.py``'s engine
classes (deadlines, the bounded queue, sibling cleanup, priority
admission, preemption) and ``tests/test_chunked_prefill.py``'s engine
tests (knobs, the slice planner, the budget accounting), a sampled
stream reproducing its tokens after an eviction, and ``StreamingLM``'s
SLO terms.
"""

import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, _Stream
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.utils import deadlines

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
JAX_ENV = dict(SELDON_TPU_PAGED_KERNEL="force", SELDON_TPU_CHUNK_IMPL="pool", SELDON_TPU_PAGED_KERNEL_IMPL="stream")


@contextlib.contextmanager
def _env(**kv):
    before = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _prompts(sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in sizes]


PRESSURE = dict(max_slots=4, num_pages=9, max_steps_per_call=16, prefix_cache=False)
PRESSURE_SIZES = (9, 7, 12, 10)
PRESSURE_NEW = 16
BUDGET = dict(max_slots=3, chunk_token_budget=24, prefix_cache=False)
BUDGET_SIZES = (5, 40, 70)
PREEMPT = dict(max_slots=2, num_pages=7, prefix_cache=False)


def _pressure(make):
    eng = make(**PRESSURE)
    streams = [eng.submit(p, max_new_tokens=PRESSURE_NEW) for p in _prompts(PRESSURE_SIZES)]
    eng.run()
    s = eng.engine_stats()
    return [x.result.tolist() for x in streams], {k: s[k] for k in ("stalls", "evictions", "completed")}, eng


def _budgeted(make):
    eng = make(**BUDGET)
    streams = [eng.submit(p, max_new_tokens=8) for p in _prompts(BUDGET_SIZES)]
    eng.run()
    s = eng.engine_stats()
    return [x.result.tolist() for x in streams], {k: s[k] for k in ("prefill_tokens", "prefill_chunks")}


def _preempting(make):
    eng = make(**PREEMPT)
    batch = eng.submit(np.arange(17), max_new_tokens=24, priority=0)
    for _ in range(4):
        eng.step()
    grown = len(batch.pages)
    vip = eng.submit(np.arange(17) + 1, max_new_tokens=4, priority=5)
    eng.run()
    s = eng.engine_stats()
    return ([batch.result.tolist(), vip.result.tolist()], grown,
            {k: s[k] for k in ("preempted", "restored", "evictions", "completed")})


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


@pytest.fixture(scope="module")
def jax_results(flax_params):
    def make(**kw):
        return jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **kw})

    with _env(**JAX_ENV, SELDON_TPU_FLIGHT_RECORDER="256"):
        tokens, counters, eng = _pressure(make)
        steps = {}
        for rec in eng.engine_stats(detail=True)["recorder"]:
            if rec["phase"] == "decode":
                steps[rec["steps"]] = steps.get(rec["steps"], 0) + 1
        return {"pressure": (tokens, counters, steps), "budget": _budgeted(make), "preempt": _preempting(make)}


@pytest.fixture
def make(params, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")

    def make(**kw):
        return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})

    return make


# ---------------------------------------------------------------------------
# against the JAX engine
# ---------------------------------------------------------------------------

def test_pool_pressure_stalls_evicts_and_ladders_as_jax(make, jax_results):
    tokens, counters, eng = _pressure(make)
    want_tokens, want_counters, want_steps = jax_results["pressure"]
    assert tokens == want_tokens
    assert counters == want_counters and counters["stalls"] > 0 and counters["evictions"] > 0
    assert eng.engine_stats()["chunk_steps"] == want_steps and max(want_steps) > ENGINE["steps_per_call"]
    full = make(**{**PRESSURE, "num_pages": None})
    streams = [full.submit(p, max_new_tokens=PRESSURE_NEW) for p in _prompts(PRESSURE_SIZES)]
    full.run()
    assert [s.result.tolist() for s in streams] == tokens  # the shrunk pool costs time, never tokens
    assert full.engine_stats()["evictions"] == 0


def test_chunked_prefill_equals_the_jax_engine(make, jax_results):
    tokens, counters = _budgeted(make)
    want_tokens, want_counters = jax_results["budget"]
    assert tokens == want_tokens and counters == want_counters
    assert counters["prefill_tokens"] == sum(BUDGET_SIZES)
    off = make(**{**BUDGET, "chunk_token_budget": 0})
    streams = [off.submit(p, max_new_tokens=8) for p in _prompts(BUDGET_SIZES)]
    off.run()
    assert [s.result.tolist() for s in streams] == tokens  # budget on = budget off
    assert off.engine_stats()["prefill_chunks"] < counters["prefill_chunks"]


def test_preemption_restores_as_the_jax_engine(make, jax_results):
    got = _preempting(make)
    assert got == jax_results["preempt"]
    tokens, grown, counters = got
    assert grown >= 5 and counters["preempted"] >= 1 and counters["restored"] >= 1
    fresh = make(max_slots=2, prefix_cache=False)
    assert tokens[0] == fresh.generate(np.arange(17), max_new_tokens=24).tolist()  # re-derived exactly


# ---------------------------------------------------------------------------
# the ladder, eviction and sampling
# ---------------------------------------------------------------------------

def test_ladder_doubles_only_with_nothing_queued(make):
    eng = make(max_slots=1, max_steps_per_call=16)
    first = eng.submit(_prompts((9,))[0], max_new_tokens=8)
    second = eng.submit(_prompts((11,))[0], max_new_tokens=40)
    eng.step()
    assert eng.engine_stats()["chunk_steps"] == {4: 1}  # a queued stream pins the short chunk
    eng.run()
    steps = eng.engine_stats()["chunk_steps"]
    assert first.result is not None and second.result is not None
    assert max(steps) == 16 and set(steps) <= {4, 8, 16}


def test_an_evicted_sampled_stream_reproduces_its_tokens(make):
    """A sampled stream re-seeds its generator when it is admitted again,
    so an eviction costs time, never other tokens (C5)."""
    prompts = _prompts(PRESSURE_SIZES, seed=8)
    kw = dict(max_new_tokens=PRESSURE_NEW, temperature=0.9, top_k=12)

    def run(**engine):
        eng = make(**engine)
        streams = [eng.submit(p, seed=100 + i, **kw) for i, p in enumerate(prompts)]
        eng.run()
        return [s.result.tolist() for s in streams], eng.engine_stats()

    tight, stats = run(**PRESSURE)
    full, full_stats = run(**{**PRESSURE, "num_pages": None})
    assert stats["evictions"] > 0 and full_stats["evictions"] == 0
    assert tight == full


# ---------------------------------------------------------------------------
# deadlines (tests/test_slo_lifecycle.py TestEngineDeadlines)
# ---------------------------------------------------------------------------

def test_expired_submit_fast_fails_before_queueing(make):
    eng = make()
    with pytest.raises(MicroserviceError) as err:
        eng.submit(np.arange(8), deadline=time.monotonic() - 0.01)
    assert err.value.status_code == 504 and err.value.reason == "DEADLINE_EXCEEDED"
    assert eng.engine_stats()["queued"] == 0


def test_queued_expiry_is_shed_before_the_device(make):
    eng = make(max_slots=1)
    healthy = eng.submit(np.arange(8), max_new_tokens=8)
    doomed = eng.submit(np.arange(8) + 1, max_new_tokens=8, deadline=time.monotonic() + 0.05)
    time.sleep(0.1)
    eng.run()
    assert healthy.result is not None
    assert doomed.error.reason == "DEADLINE_EXCEEDED" and "queue" in str(doomed.error)
    stats = eng.engine_stats()
    assert stats["expired"] == 1 and stats["prefills"] == 1  # the expired stream never prefilled


def test_mid_decode_expiry_retires_at_the_chunk_boundary(make):
    eng = make(max_slots=1)
    stream = eng.submit(np.arange(8), max_new_tokens=40, deadline=time.monotonic() + 60.0)
    eng.step()  # admit + prefill + the first chunk
    assert stream.error is None and len(stream.tokens) == ENGINE["steps_per_call"]
    stream.deadline = time.monotonic()  # the budget runs out while it decodes
    eng.run()
    assert stream.error.reason == "DEADLINE_EXCEEDED" and "decode (req 0, 4 tokens in)" in str(stream.error)
    stats = eng.engine_stats()
    assert stats["expired"] == 1 and stats["chunks"] == 1 and not eng.has_work()
    assert stats["free_pages"] + stats["prefix_pages_cached"] == eng.num_pages - 1
    assert eng.generate(np.arange(6), max_new_tokens=4).shape == (4,)  # the engine stays healthy


def test_no_deadline_streams_never_expire(make):
    eng = make()
    assert eng.generate(np.arange(10), max_new_tokens=8).shape == (8,)
    stats = eng.engine_stats()
    assert stats["expired"] == 0 and stats["shed"] == 0


# ---------------------------------------------------------------------------
# the bounded queue (TestBoundedQueueShedding)
# ---------------------------------------------------------------------------

def test_overflow_sheds_expired_first(make):
    eng = make(max_slots=1, max_queue=2)
    running = eng.submit(np.arange(8), max_new_tokens=16)
    eng.step()  # occupy the slot so later submits queue
    doomed = eng.submit(np.arange(8) + 1, deadline=time.monotonic() + 0.05)
    healthy = eng.submit(np.arange(8) + 2, max_new_tokens=4)
    time.sleep(0.1)
    late = eng.submit(np.arange(8) + 3, max_new_tokens=4)  # the full queue drops the expired one, not the healthy
    assert doomed.error.reason == "DEADLINE_EXCEEDED"
    eng.run()
    assert healthy.result is not None and late.result is not None and running.result is not None
    assert eng.engine_stats()["expired"] == 1


def test_overflow_sheds_the_lowest_priority_for_a_higher_one(make):
    eng = make(max_slots=1, max_queue=2)
    eng.submit(np.arange(8), max_new_tokens=16)
    eng.step()
    low = eng.submit(np.arange(8) + 1, max_new_tokens=4, priority=0)
    mid = eng.submit(np.arange(8) + 2, max_new_tokens=4, priority=1)
    vip = eng.submit(np.arange(8) + 3, max_new_tokens=4, priority=5)
    assert low.error.reason == "SHED" and low.error.status_code == 503
    assert str(low.error) == ("shed under overload: queue full (2) and a priority-5 request arrived "
                              "(this stream: priority 0)")
    eng.run()
    assert mid.result is not None and vip.result is not None
    assert eng.engine_stats()["shed"] == 1


def test_overflow_refuses_the_newcomer_when_it_ranks_lowest(make):
    eng = make(max_slots=1, max_queue=1)
    eng.submit(np.arange(8), max_new_tokens=16)
    eng.step()
    queued = eng.submit(np.arange(8) + 1, max_new_tokens=4, priority=2)
    with pytest.raises(MicroserviceError) as err:
        eng.submit(np.arange(8) + 2, max_new_tokens=4, priority=2)
    assert err.value.reason == "SHED" and err.value.status_code == 503
    assert str(err.value) == "queue full (1) and every queued stream has priority >= 2: request shed under overload"
    eng.run()
    assert queued.result is not None and eng.engine_stats()["shed"] == 1


def test_the_unbounded_default_never_sheds(make, monkeypatch):
    eng = make(max_slots=1)
    assert eng.max_queue == 0
    streams = [eng.submit(np.arange(8) + i, max_new_tokens=2) for i in range(8)]
    eng.run()
    assert all(s.result is not None for s in streams) and eng.engine_stats()["shed"] == 0
    monkeypatch.setenv("SELDON_TPU_MAX_QUEUE", "3")
    assert make().max_queue == 3 and make(max_queue=5).max_queue == 5  # the constructor wins


def test_a_failed_row_cancels_its_submitted_siblings(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    comp = StreamingLM(device="cpu", dtype="float32", max_new_tokens=4, max_slots=1, page_size=8, steps_per_call=2,
                       max_queue=1, **CFG)
    comp.load()
    try:
        blocker = comp.engine.submit(np.arange(8, dtype=np.int32), max_new_tokens=40)
        comp._wake.set()
        for _ in range(200):
            if blocker.slot is not None:
                break
            time.sleep(0.01)
        # row 0 fills the queue; row 1 overflows and equal priority refuses it
        with pytest.raises(MicroserviceError) as err:
            comp.predict(np.asarray([[1, 2, 3], [4, 5, 6]], np.int32), [])
        assert err.value.reason == "SHED"
        blocker.event.wait(timeout=60)
        for _ in range(500):
            if not comp.engine.has_work():
                break
            time.sleep(0.01)
        assert not comp.engine.has_work()
        # the warm-up and the blocker: row 0 was resolved from the queue
        assert comp.engine.engine_stats()["completed"] == 2
    finally:
        comp.unload()


# ---------------------------------------------------------------------------
# priority admission and preemption (TestPriorityAdmission,
# TestPreemptiveEvictRestore)
# ---------------------------------------------------------------------------

def test_higher_priority_admits_first(make):
    eng = make(max_slots=1)
    eng.generate(np.arange(8), max_new_tokens=4)
    low = eng.submit(np.arange(8) + 1, max_new_tokens=4, priority=0)
    high = eng.submit(np.arange(8) + 2, max_new_tokens=4, priority=3)
    eng.step()
    assert high.slot is not None and low.slot is None
    eng.run()
    assert high.t_finish <= low.t_prefill_start


def test_equal_priorities_stay_fifo(make):
    eng = make(max_slots=1)
    first = eng.submit(np.arange(8), max_new_tokens=4)
    second = eng.submit(np.arange(8) + 1, max_new_tokens=4)
    eng.step()
    assert first.slot is not None and second.slot is None
    eng.run()
    assert first.result is not None and second.result is not None


def test_equal_priority_never_preempts(make):
    eng = make(**PREEMPT)
    a = eng.submit(np.arange(17), max_new_tokens=16, priority=1)
    for _ in range(3):
        eng.step()
    b = eng.submit(np.arange(17) + 1, max_new_tokens=4, priority=1)
    eng.run()
    assert a.result is not None and b.result is not None
    assert eng.engine_stats()["preempted"] == 0


def test_a_higher_priority_arrival_preempts_for_a_slot(make):
    eng = make(max_slots=1)
    batch = eng.submit(np.arange(12), max_new_tokens=30, priority=0)
    eng.step()
    vip = eng.submit(np.arange(12) + 1, max_new_tokens=4, priority=2)
    eng.step()
    assert vip.slot is not None and batch.slot is None and batch.tokens == []
    eng.run()
    stats = eng.engine_stats()
    assert stats["preempted"] == stats["restored"] == 1
    np.testing.assert_array_equal(batch.result, make(max_slots=1).generate(np.arange(12), max_new_tokens=30))


def test_the_audit_stays_clean_through_preemption(make, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_DEBUG", "1")
    eng = make(**{**PREEMPT, "prefix_cache": True})
    batch = eng.submit(np.arange(17), max_new_tokens=24, priority=0)
    for _ in range(4):
        eng.step()
    vip = eng.submit(np.arange(17) + 1, max_new_tokens=4, priority=5)
    eng.run()  # audits at every chunk boundary
    assert vip.result is not None and batch.result is not None
    with eng._lock:
        eng._check_invariants_locked()


# ---------------------------------------------------------------------------
# chunked prefill (tests/test_chunked_prefill.py)
# ---------------------------------------------------------------------------

def test_budget_knob_resolution(make, monkeypatch):
    monkeypatch.setenv("SELDON_TPU_CHUNK_TOKEN_BUDGET", "64")
    assert make(chunk_token_budget=24).chunk_token_budget == 24  # the constructor wins
    assert make().chunk_token_budget == 64
    monkeypatch.setenv("SELDON_TPU_CHUNK_TOKEN_BUDGET", "0")
    assert make().chunk_token_budget == 0
    assert make(chunk_token_budget=5).chunk_token_budget == 8 + 4  # clamped to a page plus a chunk


def _stream(eng, n, priority=0, req_id=0):
    s = _Stream(req_id, np.zeros(n, np.int32), 4, 0.0, 0, -1, 0)
    s.priority = priority
    return s


def test_slices_are_page_aligned_unless_final(make):
    eng = make(chunk_token_budget=24)
    a = _stream(eng, 50, req_id=1)
    assert eng._plan_prefill_slices_locked([a], 20) == [(a, 0, 16)]
    a.prefilled = 48
    assert eng._plan_prefill_slices_locked([a], 20) == [(a, 48, 2)]


def test_the_budget_is_a_hard_cap_fifo_within_a_class_priority_first(make):
    eng = make(chunk_token_budget=24)
    a, b = _stream(eng, 64, req_id=1), _stream(eng, 64, req_id=2)
    assert eng._plan_prefill_slices_locked([a, b], 20) == [(a, 0, 16)]
    assert eng._plan_prefill_slices_locked([b, a], 32) == [(a, 0, 32)]
    lo, hi = _stream(eng, 64, priority=0, req_id=1), _stream(eng, 64, priority=2, req_id=2)
    assert eng._plan_prefill_slices_locked([lo, hi], 16) == [(hi, 0, 16)]


def test_no_wave_exceeds_the_budget(make):
    budget = 24
    eng = make(chunk_token_budget=budget, max_slots=3)
    streams = [eng.submit(p, max_new_tokens=12) for p in _prompts((5, 70, 120, 33, 64))]
    mixed = 0
    while eng.has_work():
        before = eng.engine_stats()
        eng.step()
        after = eng.engine_stats()
        prefill, decode = (after[k] - before[k] for k in ("prefill_tokens", "tokens"))
        assert prefill + decode <= budget
        mixed += bool(prefill and decode)
    assert all(s.result is not None for s in streams) and mixed > 0


def test_decode_is_admitted_first(make):
    eng = make(chunk_token_budget=16, max_slots=3)  # 3 lanes x 4 steps leave 4 < a page
    short = [eng.submit(p, max_new_tokens=16) for p in _prompts((5, 6, 7))]
    while any(s.prefilled < len(s.prompt) for s in short):
        eng.step()
    long = eng.submit(_prompts((120,), seed=9)[0], max_new_tokens=4)
    before = eng.engine_stats()
    eng.step()
    after = eng.engine_stats()
    assert after["tokens"] > before["tokens"] and after["prefill_tokens"] == before["prefill_tokens"]
    assert long.prefilled == 0
    eng.run()
    assert long.result is not None


def test_a_completed_prompt_decodes_from_the_next_wave(make):
    eng = make(chunk_token_budget=24, max_slots=1)
    s = eng.submit(_prompts((20,))[0], max_new_tokens=4)
    eng.step()
    assert s.prefilled == 20 and not s.tokens and eng.engine_stats()["chunks"] == 0
    eng.step()
    assert len(s.tokens) > 0


def test_a_long_prompt_spreads_over_waves(make):
    eng = make(chunk_token_budget=16, max_slots=1)
    assert eng.generate(_prompts((100,))[0], max_new_tokens=4).shape == (4,)
    s = eng.engine_stats()
    assert s["prefill_chunks"] >= 7 and s["prefill_tokens"] == 100


def test_prefill_tokens_match_monolithic(make):
    stats = {}
    for budget in (0, 24):
        eng = make(chunk_token_budget=budget, prefix_cache=False)
        for p in _prompts((30, 70)):
            eng.generate(p, max_new_tokens=4)
        stats[budget] = eng.engine_stats()
    assert stats[0]["prefill_tokens"] == stats[24]["prefill_tokens"] == 100
    assert stats[24]["prefill_chunks"] > stats[0]["prefill_chunks"]


def test_lifecycle_stamps_are_ordered(make):
    eng = make(chunk_token_budget=24)
    s = eng.submit(_prompts((40,))[0], max_new_tokens=6)
    eng.run()
    assert 0 < s.t_submit <= s.t_prefill_start <= s.t_first_token <= s.t_finish


# ---------------------------------------------------------------------------
# StreamingLM's SLO terms
# ---------------------------------------------------------------------------

def test_slo_terms_read_the_tags_and_the_ambient_deadline():
    priority, deadline = StreamingLM._slo_terms({"priority": "99", "deadline_ms": "50"})
    assert priority == deadlines.MAX_PRIORITY and 0 < deadline - time.monotonic() <= 0.05
    assert StreamingLM._slo_terms({}) == (0, None)
    assert StreamingLM._slo_terms({"priority": "high"}) == (0, None)
    with deadlines.activate(deadlines.Deadline.after_ms(20)):
        _, ambient = StreamingLM._slo_terms({"deadline_ms": "5000"})
        assert ambient - time.monotonic() <= 0.02  # the tightest wins
    absolute = time.monotonic() + 1.0
    assert StreamingLM._slo_terms({"deadline_at_monotonic": absolute})[1] == absolute


def test_a_spent_budget_over_predict_is_a_504(monkeypatch):
    monkeypatch.setenv("SELDON_TPU_PAGED_KERNEL", "force")
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=4, max_queue=4, chunk_token_budget=32,
                     max_steps_per_call=16, **CFG, **ENGINE)
    lm.load()
    try:
        with pytest.raises(MicroserviceError) as err:
            lm.predict(np.arange(8)[None], [], {"tags": {"deadline_ms": 0}})
        assert err.value.status_code == 504 and "paged-engine submit" in str(err.value)
        out = lm.predict(np.arange(8)[None], [], {"tags": {"priority": 2, "deadline_ms": 60000}})
        assert out.shape == (1, 4)
        status = lm.health_status()
        assert status["max_queue"] == 4 and status["chunk_token_budget"] == 32
        assert lm.engine.max_steps == 16
        metrics = {m["key"] for m in lm.metrics()}
        assert {"paged_evictions", "paged_stall_events", "paged_shed", "paged_expired", "paged_preempted",
                "paged_restored"} <= metrics
    finally:
        lm.unload()
