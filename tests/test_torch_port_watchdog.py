"""The port's device-health watchdog against the JAX package's, and the
engine's health as ``evacuate_streams`` reads it.

* One ``observe()`` sequence gives the same state after every wave, the
  same trips and the same ``stats()`` in both packages: wall breaches,
  the compile exemption, a fault rate, a compile storm, allocator
  pressure, recovery, escalation, and the force knob set and cleared.
* The engine: a cold engine whose waves run first-seen chunk signatures
  or build a kernel library cannot reach ``degraded``, however slow
  those waves are; a ceiling under every warm chunk drives it to
  ``degraded`` and then ``evacuating``; ``engine_stats()`` carries
  ``health`` / ``health_state`` / ``watchdog_trips`` (and the window with
  ``detail=True``), and with ``SELDON_TPU_WATCHDOG=0`` always "healthy".
* ``evacuate_streams`` skips a degraded and an evacuating peer and moves
  every stream to the healthy one, with no token lost.
"""

import contextlib
import os

import numpy as np
import pytest

from seldon_core_tpu.utils import watchdog as jax_watchdog
from seldon_core_tpu_torch.models.disagg import evacuate_streams
from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.ops import _build
from seldon_core_tpu_torch.utils import watchdog

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
KW = dict(window=4, breaches=2, chunk_ms_ceiling=10.0, fault_rate=0.5, compile_storm=3, hbm_pct=90.0)


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


W = dict(wall_ms=20.0)  # a breach of the 10 ms ceiling
OK = dict(wall_ms=2.0)
SEQUENCES = {
    "breaches_then_recovery": [W, W, W, OK, OK, OK, OK, OK],
    "escalation": [W] * 9,
    "compile_exemption": [dict(wall_ms=5000.0, compiled=True, compiles_delta=1)] * 2 + [OK] * 4,
    "compile_storm": [dict(wall_ms=1.0, compiled=True, compiles_delta=2)] * 3 + [OK] * 5,
    "fault_rate": [dict(wall_ms=0.0, fault=True), OK] * 3,
    "pressure": [dict(wall_ms=1.0, pool_used_pct=95.0)] * 3 + [OK] * 4,
    "mixed": [W, dict(wall_ms=30.0, compiled=True), W, OK, dict(wall_ms=0.0, fault=True), W, W, OK],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_observe_sequences_match_jax(name):
    mine, theirs = watchdog.EngineWatchdog(**KW), jax_watchdog.EngineWatchdog(**KW)
    got = [mine.observe(**wave) for wave in SEQUENCES[name]]
    want = [theirs.observe(**wave) for wave in SEQUENCES[name]]
    assert got == want
    assert mine.stats() == theirs.stats()
    assert watchdog.STATE_CODES == jax_watchdog.STATE_CODES


def test_force_knob_set_and_cleared_matches_jax():
    mine, theirs = watchdog.EngineWatchdog(**KW), jax_watchdog.EngineWatchdog(**KW)
    states = []
    for force in (None, None, None, None, "1", "1", None, None):
        with _env(SELDON_TPU_FORCE_EVACUATE=force):
            states.append((mine.observe(**OK), theirs.observe(**OK)))
    assert [a for a, _b in states] == [b for _a, b in states]
    # a forced engine recovers once the knob clears (its window is clean)
    assert [a for a, _b in states][3:] == ["healthy", "evacuating", "evacuating", "healthy", "healthy"]
    assert mine.stats() == theirs.stats()


def test_defaults_come_from_the_same_knobs():
    with _env(SELDON_TPU_WATCHDOG_CHUNK_MS="7.5", SELDON_TPU_WATCHDOG_WINDOW="6", SELDON_TPU_WATCHDOG_BREACHES="3",
              SELDON_TPU_WATCHDOG_COMPILES="4", SELDON_TPU_WATCHDOG_HBM_PCT="80", SELDON_TPU_WATCHDOG_FAULT_RATE="0.25"):
        assert watchdog.EngineWatchdog().stats() == jax_watchdog.EngineWatchdog().stats()
    assert watchdog.EngineWatchdog().stats() == jax_watchdog.EngineWatchdog().stats()


# ---------------------------------------------------------------------------
# the engine's health
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def params():
    import torch

    return load_lm_params("", CFG, 0, torch.device("cpu"))


def _prompts(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG["vocab_size"], size=(10 + i,)).astype(np.int32) for i in range(n)]


def _engine(params, **env):
    with _env(SELDON_TPU_WATCHDOG_WINDOW="4", SELDON_TPU_WATCHDOG_BREACHES="2", **env):
        return PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)


def test_a_cold_engine_cannot_degrade_from_first_waves(params, monkeypatch):
    # every wave of this engine is a compile wave: a first-seen chunk
    # signature or a kernel library built meanwhile; each is far over a
    # near-zero ceiling, and the engine stays healthy
    eng = _engine(params, SELDON_TPU_WATCHDOG_CHUNK_MS="0.000001")
    events = [_build.build_events()]

    def one_build_a_wave():
        events[0] += 1
        return events[0]

    monkeypatch.setattr(_build, "build_events", one_build_a_wave)
    for p in _prompts(3):
        eng.generate(p, max_new_tokens=12)
    stats = eng.engine_stats(detail=True)
    assert stats["health"] == "healthy" and stats["watchdog_trips"] == 0
    assert stats["watchdog"]["wall_breaches"] == 0 and stats["watchdog"]["window_compiles"] >= 4


def test_first_seen_signatures_are_exempt_then_breaches_count(params):
    eng = _engine(params, SELDON_TPU_WATCHDOG_CHUNK_MS="0.000001")
    eng.generate(_prompts(1)[0], max_new_tokens=4)  # one wave: its prefill's and its chunk's signatures are new
    stats = eng.engine_stats(detail=True)
    assert stats["health"] == "healthy" and stats["watchdog"]["window_compiles"] == 2
    eng.generate(_prompts(1)[0], max_new_tokens=24)  # the same signature again and again
    stats = eng.engine_stats(detail=True)
    assert stats["health"] in ("degraded", "evacuating") and stats["watchdog_trips"] == 1
    assert stats["health_state"] == watchdog.STATE_CODES[stats["health"]]
    for _ in range(6):
        eng.generate(_prompts(1)[0], max_new_tokens=4)
    assert eng.engine_stats()["health"] == "evacuating"


def test_watchdog_off_always_reports_healthy(params):
    eng = _engine(params, SELDON_TPU_WATCHDOG="0", SELDON_TPU_WATCHDOG_CHUNK_MS="0.000001")
    for _ in range(4):
        eng.generate(_prompts(1)[0], max_new_tokens=12)
    stats = eng.engine_stats(detail=True)
    assert (stats["health"], stats["health_state"], stats["watchdog_trips"]) == ("healthy", 0, 0)
    assert "watchdog" not in stats


def test_evacuate_streams_skips_degraded_and_evacuating_peers(params):
    src = _engine(params)
    degraded = _engine(params, SELDON_TPU_WATCHDOG_CHUNK_MS="0.000001")
    forced = _engine(params)
    healthy = _engine(params)
    ref = _engine(params)
    want = [ref.generate(p, max_new_tokens=16) for p in _prompts()]
    # the first wave runs two new signatures, the second the prefix cache's
    # suffix prefill: both exempt, then two breaches degrade the engine
    for _ in range(4):
        degraded.generate(_prompts(1)[0], max_new_tokens=4)
    with _env(SELDON_TPU_FORCE_EVACUATE="1"):
        forced.generate(_prompts(1)[0], max_new_tokens=4)
    assert degraded.engine_stats()["health"] == "degraded"
    assert forced.engine_stats()["health"] == "evacuating"
    streams = [src.submit(p, max_new_tokens=16, stream_tokens=True) for p in _prompts()]
    src.step()
    summary = evacuate_streams(src, [degraded, forced, healthy])
    assert summary["migrated"] == 4 and summary["failed"] == 0
    healthy.run()
    assert degraded.engine_stats()["migrated_in"] == forced.engine_stats()["migrated_in"] == 0
    assert healthy.engine_stats()["migrated_in"] == 4
    for s, w in zip(streams, want):
        np.testing.assert_array_equal(s.result, w)
