"""Live migration and the KV-page handoff of the port's ``PagedEngine``
against the JAX engine's.

One flax ``TransformerLM`` init in float32 serves both packages.  A stream
decoded for three waves on a port engine and moved with
``migrate_export`` / ``migrate_import`` finishes with the tokens of an
uninterrupted run, greedy and sampled (the stream's ``torch.Generator``
state travels), on the native and the int8 pool, with an adapter, and
through one token queue with no token lost or repeated (the JAX suite's
``tests/test_migration.py``).  Across packages (the JAX engine on its
split pool, the kernel lane forced): a JAX migration container resumes on
the port, a port container resumes on the JAX engine, and a
``prefill_export`` payload of either decodes on the other, with the
greedy tokens of the uninterrupted run, exactly.  Around them: the
streams no peer takes (a speculative source, a refusing peer, a JAX
sampler key on a sampled stream) fall back to the journal; a flat pool's
container is refused with the JAX engine's geometry message; the
``kv_migration`` ingress of ``StreamingLM.predict``; and both hops are
metered on the transport series.
"""

import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.codec import bufview as jax_bufview
from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.codec import bufview
from seldon_core_tpu_torch.engine.transport import kv_handoff_hop
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.disagg import evacuate_streams, migration_journal_entry
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.ops import lora
from seldon_core_tpu_torch.runtime import MicroserviceError
from seldon_core_tpu_torch.utils import metrics

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
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


POOLS = {"native": {}, "int8": {"SELDON_TPU_KV_DTYPE": "int8", "SELDON_TPU_CHUNK_IMPL": "pool"}}


def _engine(params, pool="native", **kw):
    with _env(**POOLS[pool]):
        return PagedEngine(params, dtype="float32", device="cpu", **CFG, **{**ENGINE, **kw})


def _jax_engine(flax_params, **kw):
    # the split pool the port runs (a flat pool's containers are refused)
    with _env(SELDON_TPU_PAGED_KERNEL="force"):
        return jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **{**ENGINE, **kw})


def _prompt(n=40, seed=5):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32)


def _mid_decode(eng, prompt, waves=3, **kw):
    s = eng.submit(prompt, max_new_tokens=NEW, **kw)
    for _ in range(waves):
        eng.step()
    assert 0 < len(s.tokens) < NEW  # genuinely mid-decode
    return s


# ---------------------------------------------------------------- port to port

@pytest.mark.parametrize("pool", ["native", "int8"])
@pytest.mark.parametrize("sampling", [{}, {"temperature": 0.9, "top_k": 8}], ids=["greedy", "sampled"])
def test_mid_decode_migration_equals_the_uninterrupted_run(params, pool, sampling):
    want = _engine(params, pool).generate(_prompt(), max_new_tokens=NEW, seed=7, **sampling)
    a, b = _engine(params, pool), _engine(params, pool)
    s = _mid_decode(a, _prompt(), seed=7, **sampling)
    (payload, stream), = a.migrate_export()
    assert a.engine_stats()["migrated_out"] == 1 and (payload["key_data"].size > 0) == bool(sampling)
    assert b.migrate_import(payload, stream=stream) is s
    b.run()
    assert s.error is None
    np.testing.assert_array_equal(s.result, want)
    stats = b.engine_stats()
    assert stats["migrated_in"] == 1 and stats["prefill_tokens"] == 0  # no prefill on the peer


def test_mid_decode_migration_with_an_adapter(params):
    adapter = lora.make_lora_params(3, num_layers=CFG["num_layers"], d_model=CFG["d_model"], rank=4)

    def make():
        eng = _engine(params, max_adapters=2, lora_rank=4)
        eng.load_adapter("tenant-a", adapter)
        return eng

    want = make().generate(_prompt(), max_new_tokens=NEW, seed=7, adapter="tenant-a")
    a, b = make(), make()
    s = _mid_decode(a, _prompt(), seed=7, adapter="tenant-a")
    (payload, stream), = a.migrate_export()
    assert payload["adapter"] == "tenant-a"
    b.migrate_import(payload, stream=stream)
    b.run()
    np.testing.assert_array_equal(s.result, want)
    assert b.adapter_stats()["resident"][0]["refcount"] == 0  # the pin was released at the finish


def test_one_token_queue_across_the_migration(params):
    want = _engine(params).generate(_prompt(), max_new_tokens=NEW, seed=7)
    a, b = _engine(params), _engine(params)
    s = _mid_decode(a, _prompt(), seed=7, stream_tokens=True)
    got = []
    while s.token_queue.qsize():
        got.extend(s.token_queue.get() or [])
    summary = evacuate_streams(a, [b])
    assert summary == {"migrated": 1, "failed": 0, "journal": []}
    b.run()
    while (item := s.token_queue.get()) is not None:
        got.extend(item)
    np.testing.assert_array_equal(np.asarray(got, np.int32), want)


def test_the_container_form_builds_a_fresh_stream(params):
    want = _engine(params).generate(_prompt(), max_new_tokens=NEW, seed=7, temperature=0.7)
    a, b = _engine(params), _engine(params)
    _mid_decode(a, _prompt(), seed=7, temperature=0.7)
    (payload, _stream), = a.migrate_export()
    s2 = b.migrate_import(bufview.unpack_kv_migration(bufview.pack_kv_migration(payload)))
    b.run()
    np.testing.assert_array_equal(s2.result, want)


def test_exportable_streams_only(params):
    eng = _engine(params, chunk_token_budget=12)
    s = eng.submit(_prompt(64), max_new_tokens=8)
    eng.step()
    assert 0 < s.prefilled < 64 and eng.migrate_export() == []  # mid-prefill: journal only
    assert len(eng.drain()) == 1
    spec = _engine(params, speculative={"draft": "ngram", "draft_k": 2})
    spec.submit(_prompt(), max_new_tokens=12)
    spec.step()
    spec.step()
    assert spec.migrate_export() == [] and len(spec.drain()) == 1


@pytest.mark.parametrize("impl", ["pool", "ring"])
def test_cache_length_equals_prompt_plus_tokens_on_both_chunks(params, impl):
    with _env(SELDON_TPU_CHUNK_IMPL=impl):
        eng = _engine(params)
    assert eng._chunk_impl == impl
    streams = [eng.submit(_prompt(n, seed=n), max_new_tokens=NEW, seed=n) for n in (9, 30, 40)]
    for _ in range(3):
        eng.step()
        for s in streams:
            if s.slot is not None:
                assert int(eng._lengths[s.slot]) == len(s.prompt) + len(s.tokens)
    assert len(eng.migrate_export()) == 3


# ---------------------------------------------------------------- fallbacks

def test_refusing_peers_fall_back_to_the_journal(params):
    want = _engine(params).generate(_prompt(), max_new_tokens=NEW, seed=9)
    src, closed, wrong = _engine(params), _engine(params), _engine(params, page_size=16)
    closed.close()
    s = _mid_decode(src, _prompt(), seed=9)
    summary = evacuate_streams(src, [closed, wrong])
    assert summary["migrated"] == 0 and summary["failed"] == 1
    assert s.event.is_set() and s.error.reason == "MIGRATING"
    (entry,) = summary["journal"]
    fresh = _engine(params)
    (replayed,) = fresh.replay([entry])
    fresh.run()
    np.testing.assert_array_equal(replayed.result, want)


def test_a_jax_sampler_key_is_refused_and_journaled(params, flax_params):
    a = _jax_engine(flax_params)
    a.submit(_prompt(), max_new_tokens=NEW, seed=3, temperature=0.9)
    for _ in range(3):
        a.step()
    (payload, _stream), = a.migrate_export()
    assert np.asarray(payload["key_data"]).size == 2  # a threefry key, not a torch.Generator state
    with pytest.raises(MicroserviceError) as err:
        _engine(params).migrate_import(bufview.unpack_kv_migration(jax_bufview.pack_kv_migration(payload)))
    assert err.value.status_code == 400 and err.value.reason == "RNG_STATE_MISMATCH"
    # the same refusal inside an evacuation journals the stream
    src = _engine(params)
    s = _mid_decode(src, _prompt(), seed=3, temperature=0.9)
    real = src.migrate_export

    def with_jax_key():
        return [(dict(p, key_data=np.asarray(payload["key_data"])), st) for p, st in real()]

    src.migrate_export = with_jax_key
    summary = evacuate_streams(src, [_engine(params)])
    assert summary["failed"] == 1 and summary["journal"][0]["temperature"] == pytest.approx(0.9)
    assert s.error.reason == "MIGRATING"


def test_a_flat_pools_container_is_refused_with_the_jax_message(params, flax_params):
    flat = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    assert flat._pool_flat
    flat.submit(_prompt(), max_new_tokens=NEW, seed=7)
    for _ in range(3):
        flat.step()
    (payload, _stream), = flat.migrate_export()
    assert payload["layout"] == "flat" and np.asarray(payload["k"]).ndim == 4
    split = _jax_engine(flax_params)
    with pytest.raises(JaxMicroserviceError) as want:
        split.migrate_import(payload)
    with pytest.raises(MicroserviceError) as got:
        _engine(params).migrate_import(bufview.unpack_kv_migration(jax_bufview.pack_kv_migration(payload)))
    assert got.value.reason == want.value.reason == "KV_LAYOUT_MISMATCH"
    assert "does not fit this engine's pool geometry" in str(got.value)
    assert str(got.value).split(" (")[0] == str(want.value).split(" (")[0]


# ---------------------------------------------------------------- across packages

def test_a_jax_migration_container_resumes_on_the_port(params, flax_params):
    want = _jax_engine(flax_params).generate(_prompt(), max_new_tokens=NEW, seed=7)
    a = _jax_engine(flax_params)
    a.submit(_prompt(), max_new_tokens=NEW, seed=7)
    for _ in range(3):
        a.step()
    (payload, _stream), = a.migrate_export()
    port = _engine(params)
    s = port.migrate_import(bufview.unpack_kv_migration(jax_bufview.pack_kv_migration(payload)))
    port.run()
    np.testing.assert_array_equal(s.result, want)
    np.testing.assert_array_equal(s.result, _engine(params).generate(_prompt(), max_new_tokens=NEW, seed=7))


def test_a_port_migration_container_resumes_on_the_jax_engine(params, flax_params):
    want = _engine(params).generate(_prompt(), max_new_tokens=NEW, seed=7)
    a = _engine(params)
    _mid_decode(a, _prompt(), seed=7)
    (payload, _stream), = a.migrate_export()
    peer = _jax_engine(flax_params)
    s = peer.migrate_import(jax_bufview.unpack_kv_migration(bufview.pack_kv_migration(payload)))
    peer.run()
    np.testing.assert_array_equal(s.result, want)


def test_prefill_handoff_from_both_packages(params, flax_params):
    prompt = _prompt(27, seed=2)
    want = _engine(params).generate(prompt, max_new_tokens=NEW)
    # JAX prefill worker -> port decode engine
    handoff = jax_bufview.pack_kv_handoff(_jax_engine(flax_params).prefill_export(prompt))
    dec = _engine(params)
    s = dec.submit_prefilled(bufview.unpack_kv_handoff(handoff), max_new_tokens=NEW)
    dec.run()
    np.testing.assert_array_equal(s.result, want)
    assert dec.engine_stats()["kv_imports"] == 1 and dec.engine_stats()["prefill_tokens"] == 0
    # port prefill worker -> JAX decode engine
    worker = _engine(params)
    payload = worker.prefill_export(prompt)
    assert worker.engine_stats()["kv_exports"] == 1
    assert bufview.pack_kv_handoff(payload) == jax_bufview.pack_kv_handoff(
        {k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in payload.items()})
    jdec = _jax_engine(flax_params)
    js = jdec.submit_prefilled(jax_bufview.unpack_kv_handoff(bufview.pack_kv_handoff(payload)), max_new_tokens=NEW)
    jdec.run()
    np.testing.assert_array_equal(js.result, want)


# ---------------------------------------------------------------- the served ingress

def test_streaminglm_accepts_a_migration(params):
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=NEW, seed=0, **CFG, **ENGINE)
    lm.load()
    try:
        a = _engine(params)
        _mid_decode(a, _prompt(), seed=4)
        (payload, _stream), = a.migrate_export()
        ack = lm.predict(np.frombuffer(bufview.pack_kv_migration(payload), np.uint8)[None, :], None,
                         {"tags": {"kv_migration": 1}})
        assert ack.shape == (1, 1)
        for _ in range(500):
            if lm.engine.engine_stats()["completed"] >= 2:  # the warmup and the migrated stream
                break
            time.sleep(0.02)
        stats = lm.engine.engine_stats()
        assert stats["migrated_in"] == 1 and stats["completed"] >= 2
        with pytest.raises(MicroserviceError) as err:
            lm.predict(np.zeros((1, 64), np.uint8), None, {"tags": {"kv_migration": 1}})
        assert err.value.status_code == 400 and err.value.reason == "BAD_MIGRATION_PAYLOAD"
        gauges = {m["key"]: m["value"] for m in lm.metrics()}
        assert gauges["paged_migrated_in"] == 1
    finally:
        lm.unload()


# ---------------------------------------------------------------- metering

def _hop_count(method: str) -> float:
    text = metrics.generate_latest().decode()
    return sum(float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
               if line.startswith("seldon_tpu_transport_requests_total") and f'method="{method}"' in line)


def test_both_hops_are_metered(params):
    before = _hop_count("migrate"), _hop_count("kv_handoff")
    a, b = _engine(params), _engine(params)
    _mid_decode(a, _prompt(), seed=1)
    evacuate_streams(a, [b])
    with kv_handoff_hop("decode-pool") as hop:
        hop.zero_copy_bytes = 1024
    assert _hop_count("migrate") == before[0] + 1
    assert _hop_count("kv_handoff") == before[1] + 1


def test_migration_journal_entry_is_the_jax_schema(params, flax_params):
    from seldon_core_tpu.models.disagg import migration_journal_entry as jax_entry

    a = _engine(params)
    _mid_decode(a, _prompt(), seed=2, priority=3)
    (payload, _stream), = a.migrate_export()
    assert migration_journal_entry(payload) == jax_entry(jax_bufview.unpack_kv_migration(
        bufview.pack_kv_migration(payload)))
