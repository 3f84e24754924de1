"""Disaggregated prefill/decode in the port (``PrefillLM``,
``DisaggregatedLM``) against unified serving and the JAX package.

One flax ``TransformerLM`` init in float32, written as a msgpack file,
is every component's ``model_uri``, so the JAX engine and the port's
components decode with the same weights.  In float32 a disaggregated
front's greedy tokens equal a unified ``StreamingLM``'s and the JAX
``PagedEngine``'s, on the in-process lane and on the remote lane (a
served ``PrefillLM`` dialled over REST).  The mirror of the JAX suite's
``TestDisaggregatedLM`` and ``TestPrefillLM`` (``tests/test_disagg.py``):
the stream route, the plain fallback, priced admission, cancelled jobs,
the knobs and the gauges; then what the port adds: the prefill engines
take the front's dtype and device, the 400 and 504 texts equal the JAX
components', and a corrupted container is refused by its CRC32C on the
remote lane with nothing decoded.
"""

import asyncio
import contextlib
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_serialization

from seldon_core_tpu.codec import bufview as jax_bufview
from seldon_core_tpu.models import disagg as jax_disagg
from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.runtime.component import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.codec import bufview
from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.engine import units
from seldon_core_tpu_torch.models.disagg import DisaggregatedLM, PrefillLM
from seldon_core_tpu_torch.models.paged import StreamingLM
from seldon_core_tpu_torch.runtime import MicroserviceError
from seldon_core_tpu_torch.utils import faults

CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=256)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
NEW = 8


@pytest.fixture(scope="module")
def flax_params():
    lm = FlaxTransformerLM(dtype=jnp.float32, **CFG)
    return lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def uri(flax_params, tmp_path_factory):
    path = tmp_path_factory.mktemp("disagg") / "lm.msgpack"
    path.write_bytes(flax_serialization.to_bytes(flax_params))
    return str(path)


def _cfg(uri, dtype="float32", **kw):
    return dict(CFG, **ENGINE, max_new_tokens=NEW, model_uri=uri, device="cpu", dtype=dtype, **kw)


def _prompts(n=3, length=40, seed=5):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=(n, length)).astype(np.int32)


@contextlib.contextmanager
def _loaded(*components):
    try:
        for c in components:
            c.load()
        yield components
    finally:
        for c in components:
            c.unload()


def _jax_tokens(flax_params, prompts):
    eng = jax_paged.PagedEngine(flax_params, dtype=jnp.float32, **CFG, **ENGINE)
    try:
        return np.stack([np.asarray(eng.generate(p, max_new_tokens=NEW, seed=0)) for p in prompts])
    finally:
        eng.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _served(component):
    """``component`` behind the port's REST app on a loop of its own
    thread; yields its ``rest://`` endpoint."""
    from seldon_core_tpu_torch.runtime import rest

    port = _free_port()
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    runner = asyncio.run_coroutine_threadsafe(
        rest.serve(rest.build_app(component), host="127.0.0.1", port=port), loop).result(timeout=60)
    try:
        yield f"rest://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(timeout=60)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
        loop.close()


class TestDisaggregatedLM:
    def test_parity_with_unified_serving_and_the_jax_engine(self, flax_params, uri):
        X = _prompts()
        meta = {"tags": {"seed": 11}}
        with _loaded(StreamingLM(**_cfg(uri)), DisaggregatedLM(prefill_workers=2, **_cfg(uri))) as (uni, dis):
            a = uni.predict(X, [], dict(meta))
            warm = dis.engine.engine_stats()["prefill_tokens"]  # the load's one-token warmup
            b = dis.predict(X, [], dict(meta))
            np.testing.assert_array_equal(a, b)
            stats = dis.engine.engine_stats()
            assert stats["kv_imports"] == 3 and stats["prefill_tokens"] == warm
            assert sum(e.engine_stats()["kv_exports"] for e in dis._prefill_engines) == 3
        np.testing.assert_array_equal(b, _jax_tokens(flax_params, X))

    def test_the_remote_lane_serves_the_same_tokens(self, uri):
        X = _prompts(n=2)
        pre = PrefillLM(**_cfg(uri))
        with _loaded(pre), _served(pre) as endpoint:
            with _loaded(StreamingLM(**_cfg(uri)), DisaggregatedLM(prefill_endpoints=f'["{endpoint}"]',
                                                                   **_cfg(uri))) as (uni, dis):
                want = uni.predict(X, [], {"tags": {"seed": 3}})
                got = dis.predict(X, [], {"tags": {"seed": 3}})
                np.testing.assert_array_equal(got, want)
                assert dis.engine.engine_stats()["kv_imports"] == 2 and not dis._prefill_engines
                assert pre.engine.engine_stats()["kv_exports"] == 2
                keys = {m["key"]: m["value"] for m in dis.metrics()}
                assert keys["paged_prefill_workers"] == 1

    def test_a_corrupted_container_is_refused_and_nothing_decodes(self, uri):
        pre = PrefillLM(**_cfg(uri))
        with _loaded(pre), _served(pre) as endpoint:
            with _loaded(DisaggregatedLM(prefill_endpoints=[endpoint], **_cfg(uri))) as (dis,):
                warm = dis.engine.engine_stats()["tokens"]  # the load's warmup
                faults.configure("transport.corrupt:k=4,times=inf")
                try:
                    with pytest.raises(PayloadError, match="CRC32C"):
                        dis.predict(_prompts(n=1), [], {"tags": {"seed": 1}})
                finally:
                    faults.configure("0")
                stats = dis.engine.engine_stats()
                assert stats["kv_imports"] == 0 and stats["tokens"] == warm

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_prefill_engines_take_the_fronts_dtype(self, uri, dtype):
        with _loaded(DisaggregatedLM(prefill_workers=1, **_cfg(uri, dtype=dtype))) as (dis,):
            (eng,) = dis._prefill_engines
            assert eng.pages_k.dtype == dis.engine.pages_k.dtype == getattr(torch, dtype)
            assert eng.device == dis.engine.device == torch.device("cpu")
            out = dis.predict(_prompts(n=1), [], {"tags": {"seed": 1}})
            assert out.shape == (1, NEW) and dis.engine.engine_stats()["kv_imports"] == 1

    def test_predict_stream_routes_through_prefill(self, uri):
        X = _prompts(n=1)
        meta = {"tags": {"seed": 3}}
        with _loaded(StreamingLM(**_cfg(uri)), DisaggregatedLM(prefill_workers=1, **_cfg(uri))) as (uni, dis):
            want = uni.predict(X, [], dict(meta))[0]
            got = np.concatenate(list(dis.predict_stream(X, [], dict(meta))))
            np.testing.assert_array_equal(got, want[: len(got)])
            assert dis.engine.engine_stats()["kv_imports"] == 1

    def test_degrades_to_streaminglm_when_unconfigured(self, uri):
        with _loaded(DisaggregatedLM(**_cfg(uri))) as (dis,):
            out = dis.predict(_prompts(n=1), [], {"tags": {"seed": 1}})
            assert out.shape == (1, NEW)
            assert dis.engine.engine_stats()["kv_imports"] == 0 and not dis._prefill_threads

    def test_priced_admission_rejects_unreachable_deadline(self, uri):
        with _loaded(DisaggregatedLM(prefill_workers=1, **_cfg(uri))) as (dis,):
            X = _prompts(n=1)
            dis.predict(X, [], {"tags": {"seed": 1}})  # the cost model needs measured rates
            exports = dis._prefill_engines[0].engine_stats()["kv_exports"]
            with pytest.raises(MicroserviceError) as exc:
                dis.predict(X, [], {"tags": {"seed": 1, "deadline_ms": 0.001, "max_new_tokens": NEW}})
            assert exc.value.reason in ("DEADLINE_UNREACHABLE", "DEADLINE_EXCEEDED")
            assert dis._prefill_engines[0].engine_stats()["kv_exports"] == exports

    def test_the_504_and_400_texts_are_the_jax_components(self, uri):
        class _Priced:
            def predict_cost_s(self, prompt_len, max_new):
                return 0.25

        mine = DisaggregatedLM(prefill_workers=1, **_cfg(uri))
        theirs = jax_disagg.DisaggregatedLM(prefill_workers=1, **CFG, **ENGINE, max_new_tokens=NEW)
        mine.engine = theirs.engine = _Priced()
        spent = time.monotonic() - 1.0
        with pytest.raises(MicroserviceError) as a:
            mine._price_admission(40, NEW, spent)
        with pytest.raises(JaxMicroserviceError) as b:
            theirs._price_admission(40, NEW, spent)
        assert (a.value.status_code, a.value.reason, a.value.message) == (
            b.value.status_code, b.value.reason, b.value.message)
        assert a.value.status_code == 504 and "250 ms" in a.value.message

        pre, jax_pre = PrefillLM(**_cfg(uri)), jax_disagg.PrefillLM(**CFG, **ENGINE)
        pre.engine = jax_pre.engine = object()  # the row check comes before the engine
        with pytest.raises(MicroserviceError) as a:
            pre.predict(np.zeros((2, 8), np.int32), [], {})
        with pytest.raises(JaxMicroserviceError) as b:
            jax_pre.predict(np.zeros((2, 8), np.int32), [], {})
        assert (a.value.status_code, a.value.reason, a.value.message) == (
            b.value.status_code, b.value.reason, b.value.message) and a.value.status_code == 400

    def test_cancelled_queued_jobs_never_prefill(self, uri):
        dis = DisaggregatedLM(prefill_workers=1, **_cfg(uri))
        job = dis._enqueue_prefill(_prompts(n=1)[0], 0, dict(max_new_tokens=4, eos_id=-1, seed=0, priority=0,
                                                             deadline=None, temperature=0.0, top_k=0))
        job.cancelled = True
        with _loaded(dis):  # the worker starts, pops the flagged job, skips it
            assert job.event.wait(timeout=30)
            assert job.stream is None and job.error is None
            assert all(e.engine_stats()["kv_exports"] == 0 for e in dis._prefill_engines)

    def test_jobs_order_by_priority_then_arrival(self):
        jobs = [jax_disagg._PrefillJob(i, None, p, {}) for i, p in enumerate((0, 2, 0, 2))]
        from seldon_core_tpu_torch.models.disagg import _PrefillJob

        mine = [_PrefillJob(i, None, p, {}) for i, p in enumerate((0, 2, 0, 2))]
        assert [j.seq for j in sorted(mine)] == [j.seq for j in sorted(jobs)] == [1, 3, 0, 2]

    def test_knobs(self, uri, monkeypatch):
        monkeypatch.setenv("SELDON_TPU_PREFILL_WORKERS", "3")
        monkeypatch.setenv("SELDON_TPU_ADMISSION_PRICING", "0")
        dis = DisaggregatedLM(**_cfg(uri))
        assert dis.prefill_workers == 3 and dis.admission_pricing is False
        assert DisaggregatedLM(prefill_workers=1, **_cfg(uri)).prefill_workers == 1

    def test_metrics_carry_disagg_gauges(self, uri):
        with _loaded(DisaggregatedLM(prefill_workers=1, **_cfg(uri))) as (dis,):
            dis.predict(_prompts(n=1), [], {"tags": {"seed": 1}})
            keys = {m["key"]: m["value"] for m in dis.metrics()}
            assert keys["paged_kv_imports"] == 1
            assert keys["paged_kv_exports"] == 1
            assert keys["paged_prefill_workers"] == 1

    def test_registered_under_the_jax_names(self):
        assert units._lookup_builtin("DISAGGREGATED_LM") is DisaggregatedLM
        assert units._lookup_builtin("PREFILL_LM") is PrefillLM


class TestPrefillLM:
    def test_returns_container_as_uint8_row(self, flax_params, uri):
        X = _prompts(n=1)
        with _loaded(PrefillLM(**_cfg(uri)), StreamingLM(**_cfg(uri))) as (pre, uni):
            row = pre.predict(X, [], {})
            assert row.dtype == np.uint8 and row.ndim == 2 and row.shape[0] == 1
            buf = np.ascontiguousarray(row[0]).tobytes()
            payload = bufview.unpack_kv_handoff(buf)
            s = uni.engine.submit_prefilled(payload, max_new_tokens=NEW, seed=0)
            uni._wake.set()
            assert s.event.wait(timeout=30) and s.error is None
            want = _jax_tokens(flax_params, X)[0]
            np.testing.assert_array_equal(s.result, want)
            # the JAX package reads the same container
            theirs = jax_bufview.unpack_kv_handoff(buf)
            np.testing.assert_array_equal(np.asarray(theirs["prompt"]), X[0])
            keys = {m["key"]: m["value"] for m in pre.metrics()}
            assert keys["paged_kv_exports"] == 1

    def test_rejects_multi_row(self, uri):
        with _loaded(PrefillLM(**_cfg(uri))) as (pre,):
            with pytest.raises(MicroserviceError) as exc:
                pre.predict(np.zeros((2, 8), np.int32), [], {})
            assert exc.value.status_code == 400
