"""Drain and replay of the port's ``PagedEngine`` and ``StreamingLM``
against the JAX package's.

The same submissions (greedy and sampled, priorities, a streamed one,
more streams than slots) run two waves on a port engine and on a JAX
engine from one flax init in float32; ``drain()`` journals equal entries
in both, and ``replay()`` of those entries on fresh engines gives equal
greedy tokens (a streamed entry's cursor suppresses the tokens its
consumer saw, in both).  A spent deadline is skipped and counted
``expired``.  ``StreamingLM.drain`` (a never-loaded one returns [])
journals its live streams as JSONL through tmp + rename, fails their
waiters 503 ``DRAINING``, and a component loaded on the journal's path
replays it and unlinks it; the microservice's SIGTERM path does that
instead of logging "component drain skipped".
"""

import asyncio
import contextlib
import json
import logging
import os
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM, journal_entry
from seldon_core_tpu_torch.runtime import MicroserviceError

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
NEW = 16


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


@pytest.fixture(scope="module")
def flax_params():
    return FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(flax_params):
    return lm_params_from_flax(flax_params)


def _prompt(n=30, seed=5):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32)


SUBMITS = [
    (_prompt(30, 1), dict(seed=1)),
    (_prompt(12, 2), dict(seed=2, temperature=0.8, top_k=5, priority=1, stream_tokens=True)),
    (_prompt(21, 3), dict(seed=3, eos_id=7)),  # queued: two slots
]


def _drained(eng):
    streams = [eng.submit(p, max_new_tokens=NEW, **kw) for p, kw in SUBMITS]
    for _ in range(2):
        eng.step()
    return streams, eng.drain()


@pytest.fixture(scope="module")
def journals(params, flax_params):
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    return {"port": (port, *_drained(port)), "jax": (jax_eng, *_drained(jax_eng))}


def test_journal_entries_equal_the_jax_engines(journals):
    port, streams, got = journals["port"]
    _jax, _jstreams, want = journals["jax"]
    assert got == want and len(got) == 3
    assert sorted(e["tokens_decoded"] for e in got) == sorted(len(s.tokens) for s in streams)
    assert all(s.error is not None and s.error.reason == "DRAINING" for s in streams)
    assert port.engine_stats()["drained"] == 3
    with pytest.raises(MicroserviceError) as err:
        port.submit(_prompt(), max_new_tokens=2)
    assert err.value.status_code == 503  # a drained engine stays closed


def test_replay_tokens_equal_the_jax_replay(journals, params, flax_params):
    entries = journals["jax"][2]
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    mine, theirs = port.replay(entries), jax_eng.replay(entries)
    port.run()
    jax_eng.run()
    assert port.engine_stats()["replayed"] == jax_eng.engine_stats()["replayed"] == 3
    # journal order is slot order, then the queue: the priority-1 sampled
    # stream took the first slot
    (sampled,) = [i for i, e in enumerate(entries) if e["temperature"] > 0]
    for i in set(range(3)) - {sampled}:  # greedy rows equal the JAX engine's
        np.testing.assert_array_equal(mine[i].result, theirs[i].result)
    # the sampled row: the port's own sample path, re-derived from its seed
    want = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE).generate(
        SUBMITS[1][0], max_new_tokens=NEW, **{k: v for k, v in SUBMITS[1][1].items() if k != "stream_tokens"})
    np.testing.assert_array_equal(mine[sampled].result, want)
    # the streamed entry resumes past the tokens its consumer saw
    cursor = entries[sampled]["streamed"]
    assert cursor > 0
    pushed = []
    while (item := mine[sampled].token_queue.get()) is not None:
        pushed.extend(item)
    assert pushed == want.tolist()[cursor:]


def test_spent_deadlines_are_skipped_and_counted_expired(params, flax_params):
    entries = [journal_entry(req_id=7, prompt=[1, 2, 3], max_new_tokens=4, deadline_remaining_ms=0.0),
               journal_entry(req_id=8, prompt=[4, 5, 6], max_new_tokens=4, deadline_remaining_ms=60_000.0)]
    port = PagedEngine(params, dtype="float32", device="cpu", **CFG, **ENGINE)
    jax_eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    for eng in (port, jax_eng):
        out = eng.replay(entries)
        assert [s.req_id for s in out] == [0]
        assert eng.engine_stats()["expired"] == 1 and eng.engine_stats()["replayed"] == 1
        assert out[0].deadline is not None and out[0].deadline > time.monotonic() + 50
    assert port.replay([dict(entries[1], adapter="nobody")]) == []  # refused: skipped, logged


def _lm(**kw):
    return StreamingLM(device="cpu", dtype="float32", max_new_tokens=64, seed=0, **CFG,
                       **{**ENGINE, "steps_per_call": 1, **kw})


def _slowed(lm, delay=0.05):
    step = lm.engine.step

    def slow():
        time.sleep(delay)
        return step()

    lm.engine.step = slow


def _in_flight(lm, n=2):
    """n unary requests decoding on ``lm``: their threads and outcomes."""
    outcomes = [None] * n

    def call(i):
        try:
            outcomes[i] = lm.predict(_prompt(10 + i, seed=i)[None, :], None, {"tags": {"seed": i}})
        except MicroserviceError as exc:
            outcomes[i] = exc

    threads = [threading.Thread(target=call, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for _ in range(500):
        live = [s for s in lm.engine._slots if s is not None]
        if len(live) == n and all(len(s.tokens) > 0 for s in live):
            break
        time.sleep(0.01)
    return threads, outcomes


def test_streaminglm_drain_journals_and_a_reload_replays(tmp_path):
    assert _lm().drain() == []  # never loaded
    path = tmp_path / "journal.jsonl"
    lm = _lm()
    lm.load()
    _slowed(lm)
    threads, outcomes = _in_flight(lm)
    entries = lm.drain(journal_path=str(path))
    for t in threads:
        t.join(timeout=30)
    assert len(entries) == 2 and all(e["tokens_decoded"] > 0 for e in entries)
    assert all(isinstance(o, MicroserviceError) and o.reason == "DRAINING" for o in outcomes)
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert lines == entries and not (tmp_path / "journal.jsonl.tmp").exists()
    with _env(SELDON_TPU_DRAIN_JOURNAL=str(path)):
        reborn = _lm()
        reborn.load()
    try:
        assert not path.exists()  # consumed: never replayed twice
        assert reborn.engine.engine_stats()["replayed"] == len(lines)
        for _ in range(500):
            if reborn.engine.engine_stats()["completed"] >= 1 + len(lines):
                break
            time.sleep(0.02)
        assert reborn.engine.engine_stats()["completed"] >= 1 + len(lines)
    finally:
        reborn.unload()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_microservice_shutdown_path_journals(tmp_path, caplog):
    from seldon_core_tpu_torch.runtime.microservice import run_servers

    path = tmp_path / "sigterm.jsonl"
    lm = _lm()
    lm.load()
    _slowed(lm)
    threads, outcomes = _in_flight(lm)

    async def serve_then_stop():
        stop = asyncio.Event()
        server = asyncio.ensure_future(run_servers(lm, api="REST", host="127.0.0.1", http_port=_free_port(),
                                                   shutdown_event=stop))
        await asyncio.sleep(0.2)
        stop.set()  # what SIGTERM sets
        await asyncio.wait_for(server, timeout=60)

    with _env(SELDON_TPU_DRAIN_JOURNAL=str(path)), caplog.at_level(logging.INFO):
        asyncio.run(serve_then_stop())
    for t in threads:
        t.join(timeout=30)
    assert "component drain skipped" not in caplog.text
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 2 and lm.engine.engine_stats()["drained"] == 2
    assert all(isinstance(o, MicroserviceError) and o.reason == "DRAINING" for o in outcomes)
