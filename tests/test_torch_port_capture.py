"""The port's request capture plane against the JAX package's, and the
replay tool.

* ``codec/bufview.pack_capture``: one capture payload packs to the same
  bytes in both packages, with the CRC32C trailer and without it, and
  each package unpacks the other's container; a corrupted container is
  a named ``PayloadError``.
* ``utils/capture.py``: ``RequestCapture`` payloads, ``redact``
  (``SELDON_TPU_CAPTURE_PAYLOADS=0``), ``phase_terms`` and
  ``CaptureStore``'s byte budget agree with the JAX module; each store
  reads the other's files.
* The engine's triggers in the JAX order: an error, then a p99-breach
  window's puid (the flight recorder's dump hook), then head sampling.
* ``StreamingLM`` captures ``predict`` and ``predict_stream`` requests
  (their tokens, seed, phase terms, waves, cost, model config and set
  knobs); ``tools/replay.py`` replays a greedy capture bit for bit on
  the CPU, reports a redacted one as not replayable, and its CLI prints
  the JSON report.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from seldon_core_tpu.codec import bufview as jax_bufview
from seldon_core_tpu.utils import capture as jax_capture
from seldon_core_tpu_torch.codec import bufview
from seldon_core_tpu_torch.codec.tensor import PayloadError
from seldon_core_tpu_torch.models.paged import StreamingLM
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.tools import replay
from seldon_core_tpu_torch.utils import capture

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)


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
        capture.reset_default_store()
        jax_capture.reset_default_store()


def _fields(seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        puid=f"puid-{seed}", trace_id="t" * 8, status="ok", trigger="sample", seed=1234 + seed, max_new_tokens=6,
        temperature=0.0, top_k=0, eos_id=-1, adapter="a1", priority=2, deadline_remaining_ms=12.5, rows=1,
        phases=jax_capture.phase_terms(1.0, 1.25, 1.5, 1.625, 2.0),
        waves=[{"phase": "decode", "puids": [f"puid-{seed}"], "wall_ms": 3.5, "steps": 4}],
        cost={"page_seconds": 0.5, "prefill_tokens": 9, "decode_tokens": 6, "preemptions": 0, "restores": 0,
              "adapter": "a1"},
        knobs=[{"name": "SELDON_TPU_CAPTURE", "value": "1"}], model={"vocab_size": 64}, tags={"seed": 3},
        time=1700000000.25,
        prompt=rng.integers(0, 64, 9).astype(np.int32), tokens=rng.integers(0, 64, 6).astype(np.int32),
    )


@pytest.mark.parametrize("checksum", ["1", "0"])
def test_capture_container_bytes_equal_the_jax_packages(checksum):
    with _env(SELDON_TPU_KV_CHECKSUM=checksum):
        mine = capture.RequestCapture(**_fields()).to_payload()
        theirs = jax_capture.RequestCapture(**_fields()).to_payload()
        assert mine["meta"] == theirs["meta"]
        blob = bufview.pack_capture(mine)
        assert blob == jax_bufview.pack_capture(theirs)
        back = bufview.unpack_capture(jax_bufview.pack_capture(theirs))
        there = jax_bufview.unpack_capture(blob)
    for got in (back, there):
        np.testing.assert_array_equal(got["prompt"], mine["prompt"])
        np.testing.assert_array_equal(got["tokens"], mine["tokens"])
        assert got["meta"] == mine["meta"]
    assert capture.RequestCapture.from_payload(back).to_payload()["meta"] == mine["meta"]


def test_a_corrupted_capture_is_refused_by_name():
    blob = bytearray(bufview.pack_capture(capture.RequestCapture(**_fields()).to_payload()))
    blob[20] ^= 0xFF
    with pytest.raises(PayloadError, match="CRC32C"):
        bufview.unpack_capture(bytes(blob))
    with pytest.raises(PayloadError, match="meta"):
        bufview.pack_capture({"prompt": [1]})


def test_redact_and_phase_terms_match_jax():
    payload = capture.RequestCapture(**_fields()).to_payload()
    for payloads in ("1", "0"):
        with _env(SELDON_TPU_CAPTURE_PAYLOADS=payloads):
            mine, theirs = capture.redact(payload), jax_capture.redact(payload)
        assert mine["meta"] == theirs["meta"]
        assert mine["prompt"].tolist() == theirs["prompt"].tolist()
        assert mine["tokens"].tolist() == theirs["tokens"].tolist()
    assert theirs["meta"]["payloads_redacted"] and theirs["prompt"].size == 0 and theirs["meta"]["prompt_len"] == 9
    for stamps in [(1.0, 1.25, 1.5, 1.625, 2.0), (1.0, 0.0, 0.0, 0.0, 3.0), (0.0,) * 5]:
        assert capture.phase_terms(*stamps) == jax_capture.phase_terms(*stamps)


def test_stores_share_files_and_the_byte_budget(tmp_path):
    one = len(bufview.pack_capture(capture.redact(capture.RequestCapture(**_fields()).to_payload())))
    mine = capture.CaptureStore(root=str(tmp_path / "port"), max_bytes=int(2.5 * one))
    theirs = jax_capture.CaptureStore(root=str(tmp_path / "jax"), max_bytes=int(2.5 * one))
    for i in range(4):
        mine.put(capture.RequestCapture(**_fields(i)))
        theirs.put(jax_capture.RequestCapture(**_fields(i)))
        os.utime(mine.path_for(f"puid-{i}"), (i, i))
        os.utime(theirs.path_for(f"puid-{i}"), (i, i))
    assert sorted(os.listdir(mine.root)) == sorted(os.listdir(theirs.root))
    assert (mine.writes, mine.evictions, mine.errors) == (theirs.writes, theirs.evictions, theirs.errors)
    assert mine.evictions >= 1 and mine.total_bytes() <= mine.max_bytes
    # each store reads the other's containers
    cross = capture.CaptureStore(root=theirs.root).get("puid-3")
    assert cross is not None and cross.seed == 1237 and cross.tokens.tolist() == _fields(3)["tokens"].tolist()
    assert jax_capture.CaptureStore(root=mine.root).get("puid-3").trigger == "sample"
    assert capture.CaptureStore(root=mine.root).puids() == jax_capture.CaptureStore(root=theirs.root).puids()


# ---------------------------------------------------------------------------
# the engine's triggers and StreamingLM
# ---------------------------------------------------------------------------

@pytest.fixture
def capture_env(tmp_path):
    with _env(SELDON_TPU_CAPTURE="1", SELDON_TPU_CAPTURE_SAMPLE="2", SELDON_TPU_CAPTURE_DIR=str(tmp_path)):
        capture.reset_default_store()
        yield tmp_path


def _lm(**kw):
    lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=8, seed=0, **CFG, **ENGINE, **kw)
    lm.load()
    return lm


def test_triggers_in_the_jax_order(capture_env):
    lm = _lm()
    try:
        eng = lm.engine
        assert eng.capture_trigger("a", RuntimeError("x")) == "error"
        eng._note_breach_puids([{"puids": ["b", ""]}], "dump.jsonl")
        assert eng.capture_trigger("b", None) == "breach"
        assert [eng.capture_trigger(p, None) for p in ("c", "d", "e", "f")] == [None, "sample", None, "sample"]
        assert eng.recorder.on_dump == eng._note_breach_puids
    finally:
        lm.unload()
    with _env(SELDON_TPU_CAPTURE=None):
        lm = _lm()
        try:
            assert lm.engine.capture_trigger("a", RuntimeError("x")) is None
            assert "captures" not in lm.engine.engine_stats()
        finally:
            lm.unload()


def test_predict_and_stream_capture_and_replay_bit_for_bit(capture_env, capsys):
    lm = _lm()
    try:
        prompt = np.arange(3, 14, dtype=np.int32)
        rows = [lm.predict(prompt[None, :], [], meta={"puid": f"req-{i}", "tags": {"seed": 7}}) for i in range(2)]
        streamed = list(lm.predict_stream(prompt[None, :], meta={"puid": "req-s", "tags": {"seed": 7}}))
        streamed += list(lm.predict_stream(prompt[None, :], meta={"puid": "req-t", "tags": {"seed": 7}}))
        stats = lm.engine.engine_stats()
    finally:
        lm.unload()
    assert stats["captures"] == 2 and stats["capture_store_bytes"] > 0  # every 2nd request
    store = capture.default_store()
    assert sorted(store.puids()) == ["req-1", "req-t"]
    cap = store.get("req-1")
    assert cap.tokens.tolist() == rows[1][0].tolist() and cap.seed == 7 and cap.trigger == "sample"
    assert cap.model["device"] == "cpu" and cap.model["dtype"] == "float32" and cap.phases["total_ms"] > 0
    assert cap.waves and all("req-1" in w["puids"] for w in cap.waves)
    assert cap.cost["decode_tokens"] == 8 and cap.cost["page_seconds"] > 0
    assert {"SELDON_TPU_CAPTURE", "SELDON_TPU_CAPTURE_SAMPLE", "SELDON_TPU_CAPTURE_DIR"} <= {
        k["name"] for k in cap.knobs}
    assert store.get("req-t").tokens.tolist() == np.concatenate(streamed[len(streamed) // 2:]).tolist()
    if not torch.cuda.is_available():  # the tool runs on the card unless told otherwise
        with pytest.raises(MicroserviceError) as err:
            replay.replay_capture(cap)
        assert err.value.reason == "NO_CUDA_DEVICE"
    report = replay.replay_capture(cap, device="cpu")
    assert report["bit_exact"] and report["replayed_tokens"] == rows[1][0].tolist()
    assert report["device"] == "cpu" and set(report["latency"]) == set(replay.PHASE_TERMS)
    assert replay.main([store.path_for("req-1"), "--device", "cpu", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["bit_exact"] is True


def test_a_redacted_capture_is_not_replayable(capture_env):
    with _env(SELDON_TPU_CAPTURE_PAYLOADS="0", SELDON_TPU_CAPTURE_SAMPLE="1"):
        lm = _lm()
        try:
            lm.predict(np.arange(5, dtype=np.int32)[None, :], [], meta={"puid": "secret"})
        finally:
            lm.unload()
        cap = capture.default_store().get("secret")
    assert cap.prompt.size == 0 and cap.tokens.size == 0
    report = replay.replay_capture(cap, device="cpu")
    assert report["replayable"] is False and "PAYLOADS" in report["info"]


def test_an_error_is_captured(capture_env):
    from seldon_core_tpu_torch.utils import faults

    lm = _lm()
    try:
        faults.configure("paged.nan:times=1")
        with pytest.raises(MicroserviceError, match="quarantined"):
            lm.predict(np.arange(9, dtype=np.int32)[None, :], [], meta={"puid": "poisoned"})
    finally:
        faults.clear()
        lm.unload()
    cap = capture.default_store().get("poisoned")
    assert cap is not None and cap.status == "error" and cap.trigger == "error" and "quarantined" in cap.reason
