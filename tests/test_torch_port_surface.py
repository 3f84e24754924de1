"""The last of the JAX package's public surface in the port, held against
the JAX functions on the same inputs:

* ``PagedEngine.submit_views`` (``tests/test_zero_copy.py:325-380``): the
  greedy ids of views admitted in one pass equal the JAX engine's for the
  same f32 weights, and a partial admission rolls back;
* ``runtime.microservice.start_custom_service``
  (``tests/test_servers.py:407-421``);
* the codec's public helpers (``get_data_from_proto``, ``build_message``,
  ``json_to_proto``, ``proto_to_json``, ``json_feedback_to_proto``,
  ``from_device_many``): the same outputs as the JAX functions, byte for
  byte on the protos;
* ``utils/jitwatch.py`` (``tests/test_observability.py:1172-1254``): one
  count and one WARN per new argument signature, the static key, the
  kill switch, ``engine_stats()["jit_compiles"]``, and the watchdog's
  compile exemption on a cold engine (``tests/test_watchdog.py:171-181``).
"""

import logging
import os
import sys
import threading
from contextlib import contextmanager

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu import codec as jax_codec
from seldon_core_tpu.models.paged import PagedEngine as JaxPagedEngine
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.proto import pb as jax_pb
from seldon_core_tpu_torch import codec
from seldon_core_tpu_torch.codec import bufview
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.runtime.microservice import start_custom_service
from seldon_core_tpu_torch.utils import jitwatch
from seldon_core_tpu_torch.utils.jitwatch import JIT_COMPILES_METRIC, JitSentinel, signature_of
from seldon_core_tpu_torch.utils.metrics import _cache_for

KNOBS = ("SELDON_TPU_CHUNK_IMPL", "SELDON_TPU_PAGED_KERNEL", "SELDON_TPU_KV_DTYPE", "SELDON_TPU_JIT_SENTINEL")


@contextmanager
def env(unset=KNOBS, **values):
    before = {k: os.environ.pop(k, None) for k in (*unset, *values)}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def flax_lm(cfg):
    lm = FlaxTransformerLM(dtype=jnp.float32, **cfg)
    return lm.init(jax.random.key(0), jnp.zeros((1, 4), jnp.int32))["params"]


def port_engine(params, cfg, **kw):
    with env():
        return PagedEngine(lm_params_from_flax(params), dtype="float32", device="cpu", page_size=8, max_slots=2,
                           steps_per_call=4, **cfg, **kw)


# ---------------------------------------------------------------- submit_views

def test_submit_views_rolls_back_a_partial_admission():
    cfg = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=64)
    eng = port_engine(flax_lm(cfg), cfg)
    ok = np.arange(5, dtype=np.int32) % 64
    too_long = np.arange(80, dtype=np.int32) % 64  # > max_len
    with pytest.raises(MicroserviceError) as err:
        eng.submit_views([ok, ok, too_long], max_new_tokens=4)
    assert err.value.status_code == 400
    # both admitted streams rolled back: nothing left queued (the port's
    # "queued" is the JAX engine's "queued_streams")
    assert eng.engine_stats()["queued"] == 0 and eng.engine_stats()["active"] == 0


def test_submit_views_ids_equal_submit_and_the_jax_engine():
    cfg = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
    params = flax_lm(cfg)
    prompts = [np.arange(5, dtype=np.int32) % 64, (np.arange(9, dtype=np.int32) * 3) % 64]
    with env():
        jeng = JaxPagedEngine(params, dtype=jnp.float32, page_size=8, max_slots=2, steps_per_call=4, **cfg)
        try:
            jax_ids = [np.asarray(jeng.generate(p, max_new_tokens=6)) for p in prompts]
        finally:
            jeng.close()
    eng = port_engine(params, cfg)
    views = [bufview.unpack_frame(bufview.pack_frame(p)) for p in prompts]
    # an int32 view is admitted without a copy: the stream's prompt reads the frame's buffer
    batched = eng.submit_views(views, max_new_tokens=6)
    assert all(np.shares_memory(s.prompt, v.array()) for s, v in zip(batched, views))
    eng.run()
    ref = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    for b, r, want in zip(batched, ref, jax_ids):
        assert b.error is None and r.error is None
        np.testing.assert_array_equal(np.asarray(b.result), np.asarray(r.result))
        np.testing.assert_array_equal(np.asarray(b.result), want)


# ---------------------------------------------------------------- custom_service

class Doubler:
    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2


def test_custom_service_runs_on_daemon_thread():
    ran = threading.Event()

    class WithService(Doubler):
        def custom_service(self):
            ran.set()

    thread = start_custom_service(WithService())
    assert thread is not None and thread.daemon and thread.name == "custom-service"
    assert ran.wait(timeout=5.0)
    thread.join(timeout=5.0)
    assert not thread.is_alive()
    assert start_custom_service(Doubler()) is None


# ---------------------------------------------------------------- the codec's public helpers

def test_codec_exports_the_jax_list():
    missing = sorted(n for n in dir(jax_codec) if not n.startswith("_") and n not in dir(codec)
                     and callable(getattr(jax_codec, n)))
    assert missing == []


PAYLOADS = [
    np.arange(6, dtype=np.float64).reshape(2, 3),   # tensor
    np.arange(6, dtype=np.float32).reshape(3, 2),   # rawTensor
    np.arange(4, dtype=np.uint8),                   # rawTensor
    np.array([True, False]),                        # rawTensor
    np.array([["a", "b"]]),                         # ndarray
    b"\x00\x01bytes",                               # binData
    "text",                                         # strData
    {"a": [1, 2], "b": {"c": "d"}},                 # jsonData
]


@pytest.mark.parametrize("i", range(len(PAYLOADS)))
def test_build_message_and_get_data_from_proto_equal_jax(i):
    payload = PAYLOADS[i]
    meta = pb.Meta(puid="p-9")
    meta.tags["k"].string_value = "v"
    ours = codec.build_message(payload, names=["x"] if isinstance(payload, np.ndarray) else None, meta=meta)
    theirs = jax_codec.build_message(payload, names=["x"] if isinstance(payload, np.ndarray) else None,
                                     meta=jax_pb.Meta.FromString(meta.SerializeToString()))
    assert ours.SerializeToString(deterministic=True) == theirs.SerializeToString(deterministic=True)
    got, want = codec.get_data_from_proto(ours), jax_codec.get_data_from_proto(theirs)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_build_message_data_type_and_empty_message():
    x = np.arange(4, dtype=np.float32)
    for kind in ("tensor", "ndarray", "rawTensor"):
        assert (codec.build_message(x, data_type=kind).SerializeToString(deterministic=True)
                == jax_codec.build_message(x, data_type=kind).SerializeToString(deterministic=True))
    with pytest.raises(codec.PayloadError):
        codec.get_data_from_proto(pb.SeldonMessage())
    with pytest.raises(jax_codec.PayloadError):
        jax_codec.get_data_from_proto(jax_pb.SeldonMessage())


BODIES = [
    {"data": {"names": ["a"], "ndarray": [[1, 2], [3, 4]]}, "meta": {"puid": "q", "tags": {"t": 1}}},
    {"data": {"tensor": {"shape": [1, 2], "values": [0.5, 1.5]}}, "unknownField": 3},
    {"strData": "hi", "status": {"code": 200, "status": "SUCCESS"}},
    {"jsonData": {"x": [1, {"y": None}]}},
]


@pytest.mark.parametrize("i", range(len(BODIES)))
def test_json_proto_round_trip_equals_jax(i):
    body = BODIES[i]
    ours, theirs = codec.json_to_proto(body), jax_codec.json_to_proto(body)
    assert ours.SerializeToString(deterministic=True) == theirs.SerializeToString(deterministic=True)
    assert codec.proto_to_json(ours) == jax_codec.proto_to_json(theirs)


def test_json_feedback_to_proto_equals_jax():
    body = {"request": BODIES[0], "response": BODIES[1], "reward": 0.25, "truth": BODIES[2], "extra": 1}
    ours, theirs = codec.json_feedback_to_proto(body), jax_codec.json_feedback_to_proto(body)
    assert ours.SerializeToString(deterministic=True) == theirs.SerializeToString(deterministic=True)
    assert codec.proto_to_json(ours) == jax_codec.proto_to_json(theirs)


def test_from_device_many_passes_host_arrays_and_casts():
    xs = [np.arange(3, dtype=np.int64), torch.arange(4, dtype=torch.float64).reshape(2, 2), [1.5, 2.5]]
    got = codec.from_device_many(xs)
    want = jax_codec.from_device_many([np.asarray(x) for x in xs])
    assert got[0] is xs[0]  # host arrays pass through untouched
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    cast = codec.from_device_many(xs, dtype=np.float32)
    assert all(a.dtype == np.float32 for a in cast)
    np.testing.assert_array_equal(cast[1], np.arange(4, dtype=np.float32).reshape(2, 2))


# ---------------------------------------------------------------- jitwatch

def counter(program: str) -> float:
    return _cache_for(None).get("counter", JIT_COMPILES_METRIC, ("program",)).labels(program=program).get()


def test_sentinel_counts_once_per_signature_and_warns(caplog):
    with env():
        sentinel = JitSentinel("test_prog_sig")
        fn = sentinel.wrap(lambda x: x * 2, static="variant=a")
    before = counter("test_prog_sig")
    with caplog.at_level(logging.WARNING, logger="seldon_core_tpu_torch.utils.jitwatch"):
        fn(torch.zeros((2, 2)))
        fn(torch.ones((2, 2)))   # same signature: no new event
        fn(np.zeros((4, 4), np.float32))  # new shape: an event
    assert sentinel.compiles == 2
    assert counter("test_prog_sig") - before == 2.0
    warns = [r for r in caplog.records if "jit compile" in r.getMessage()]
    assert len(warns) == 2
    # the WARN names the program AND the triggering signature
    assert "test_prog_sig" in warns[0].getMessage()
    assert "(2, 2)" in warns[0].getMessage()
    assert "(4, 4)" in warns[1].getMessage()


def test_sentinel_static_key_separates_variants():
    with env():
        sentinel = JitSentinel("test_prog_static")
        a = sentinel.wrap(lambda x: x + 1, static="steps=8")
        b = sentinel.wrap(lambda x: x + 2, static="steps=16")
    a(torch.zeros((2,)))
    b(torch.zeros((2,)))  # same tensor shape, distinct static key
    assert sentinel.compiles == 2


def test_sentinel_kill_switch_returns_fn_unwrapped():
    with env(SELDON_TPU_JIT_SENTINEL="0"):
        sentinel = JitSentinel("test_prog_off")
        fn = lambda x: x  # noqa: E731
        assert sentinel.wrap(fn) is fn


def test_signature_of_matches_the_jax_leaves():
    """The JAX signature's leaves on the same nested arguments: a
    tensor's or array's (shape, dtype), a scalar's type name."""
    from seldon_core_tpu.utils.jitwatch import signature_of as jax_signature_of

    arrays = [np.zeros((2, 3), np.float32), np.ones((4,), np.int32)]
    args = ((arrays[0], [arrays[1], 3]), {"b": 2.5, "a": arrays[0]})
    ours = signature_of(args, {"k": arrays[1]})[0]
    assert ours == jax_signature_of(args, {"k": arrays[1]})[0]
    torch_args = ((torch.zeros((2, 3)), [torch.ones((4,), dtype=torch.int32), 3]),
                  {"b": 2.5, "a": torch.zeros((2, 3))})
    assert signature_of(torch_args, {"k": torch.ones((4,), dtype=torch.int32)})[0] == ours
    # the nesting is part of the signature: the same leaves in another structure differ
    assert signature_of((arrays[0], arrays[1]), {}) != signature_of(([arrays[0], arrays[1]],), {})


def test_engine_stats_exposes_summed_compiles():
    """The engine wires sentinels on its chunk and prefill programs and
    engine_stats carries the sum (bridge-excluded: jitwatch exports the
    per-program split itself), which equals the counter's growth."""
    cfg = dict(vocab_size=256, d_model=64, num_layers=1, num_heads=4, max_len=128)
    with env():
        from seldon_core_tpu_torch.models.generate import load_lm_params

        eng = PagedEngine(load_lm_params("", cfg, 0), dtype="float32", device="cpu", page_size=16, max_slots=2,
                          steps_per_call=4, **cfg)
    before = {p: counter(p) for p in eng._sentinels}
    assert eng.engine_stats()["jit_compiles"] == 0
    eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=4)
    while eng.has_work():
        eng.step()
    # at least the prefill + one chunk program ran a first time
    n = eng.engine_stats()["jit_compiles"]
    assert n >= 2
    assert sum(counter(p) - before[p] for p in eng._sentinels) == n
    eng.submit(np.arange(8, dtype=np.int32), max_new_tokens=4)  # the same shapes again
    while eng.has_work():
        eng.step()
    assert eng.engine_stats()["jit_compiles"] == n
    from seldon_core_tpu_torch.utils.metrics import ENGINE_STATS_EXCLUDED

    assert "jit_compiles" in ENGINE_STATS_EXCLUDED


def test_cold_engine_never_degrades_from_first_use_alone():
    """The watchdog's compile exemption still fires: the first waves of a
    cold engine run programs under new signatures; with a ceiling far
    below their wall, the engine stays healthy because the sentinels
    flag those waves and the watchdog exempts them."""
    cfg = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=64)
    with env(SELDON_TPU_WATCHDOG_CHUNK_MS="0.000001", SELDON_TPU_WATCHDOG_BREACHES="1",
             SELDON_TPU_WATCHDOG_WINDOW="4"):
        eng = port_engine(flax_lm(cfg), cfg)
    s = eng.submit(np.arange(10), max_new_tokens=4)
    eng.run()
    assert s.result is not None
    stats = eng.engine_stats(detail=True)
    assert stats["jit_compiles"] >= 1  # the exemption actually fired
    assert stats["watchdog"]["window_compiles"] == stats["jit_compiles"]
    assert stats["health"] == "healthy"
    assert stats["watchdog_trips"] == 0


def test_module_imports_no_jax():
    src = open(jitwatch.__file__).read()
    assert "import jax" not in src and "tree_util" not in src
    assert sys.modules["seldon_core_tpu_torch.utils.jitwatch"] is jitwatch
