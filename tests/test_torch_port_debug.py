"""The port's knob registry and the gateway's debug endpoints, against
the JAX package's, and the telemetry plane's off lane.

* ``runtime/knobs.py``: every ``SELDON_TPU_*`` name the port spells is
  declared (an AST scan of the package); an undeclared read raises
  ``UndeclaredKnobError``; ``snapshot()`` entries have the JAX
  registry's keys, and a knob both packages declare has the same kind
  and default (``SELDON_TPU_CTX_BUCKETS`` excepted: unset, the port's
  follows the device).
* ``/debug/engine`` (``?detail=1``), ``/debug/traces``, ``/debug/knobs``,
  ``/debug/weights``, ``/debug/telemetry`` and ``/debug/request/{puid}``
  of a gateway serving a ``StreamingLM`` return the JAX gateway's
  payload shapes; ``/metrics`` answers an OpenMetrics ``Accept`` with
  OpenMetrics.
* The off lane (``SELDON_TPU_TELEMETRY=0``, capture unset,
  ``SELDON_TPU_FLIGHT_RECORDER=0``, ``SELDON_TPU_NAN_GUARD=0``,
  ``SELDON_TPU_WATCHDOG=0``): the same tokens as the on lane, no
  ``cost_*`` / capture keys in ``engine_stats()`` (the keys it keeps
  are the JAX engine's on its off lane), and no ``/debug/telemetry``
  route on the microservice.
"""

import ast
import asyncio
import contextlib
import os
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.engine import server as jax_server
from seldon_core_tpu.engine.graph import UnitSpec as JaxUnitSpec
from seldon_core_tpu.engine.service import PredictorService as JaxPredictorService
from seldon_core_tpu.models import paged as jax_paged
from seldon_core_tpu.models.transformer import TransformerLM as FlaxTransformerLM
from seldon_core_tpu.runtime import knobs as jax_knobs
from seldon_core_tpu.utils import capture as jax_capture
from seldon_core_tpu.utils import tracing as jax_tracing
from seldon_core_tpu_torch.engine import PredictorService, UnitSpec
from seldon_core_tpu_torch.engine import server
from seldon_core_tpu_torch.models.convert import lm_params_from_flax
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM
from seldon_core_tpu_torch.runtime import knobs, rest
from seldon_core_tpu_torch.utils import capture, tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(vocab_size=64, d_model=32, num_layers=1, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
OFF_LANE = dict(SELDON_TPU_TELEMETRY="0", SELDON_TPU_CAPTURE=None, SELDON_TPU_FLIGHT_RECORDER="0",
                SELDON_TPU_NAN_GUARD="0", SELDON_TPU_WATCHDOG="0")


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
# the knob registry
# ---------------------------------------------------------------------------

_KNOB_NAME = re.compile(r"SELDON_TPU_[A-Z0-9_]*[A-Z0-9]")


def _spelled_knobs():
    found = {}
    for path in sorted((ROOT / "seldon_core_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) and _KNOB_NAME.fullmatch(node.value):
                found.setdefault(node.value, f"{path.relative_to(ROOT)}:{node.lineno}")
    return found


def test_every_knob_the_port_spells_is_declared():
    found = _spelled_knobs()
    assert len(found) >= 40  # the scan reaches the port's readers
    assert {n: where for n, where in found.items() if not knobs.declared(n)} == {}
    with pytest.raises(knobs.UndeclaredKnobError):
        knobs.raw("SELDON_TPU_NOT_A_KNOB")
    with pytest.raises(knobs.UndeclaredKnobError):
        knobs.flag("SELDON_TPU_MAX_QUEUE")  # an int, not a flag
    assert knobs.declared("x-seldon-priority") and knobs.declared("seldon.io/hedge-ms")


def test_snapshot_has_the_jax_registrys_shape():
    env = {"SELDON_TPU_CAPTURE": "1", "SELDON_TPU_FAULT": "paged.alloc"}
    mine, theirs = knobs.snapshot(env), jax_knobs.snapshot(env)
    assert {tuple(sorted(e)) for e in mine} == {tuple(sorted(e)) for e in theirs}
    assert [e["name"] for e in mine] == sorted(e["name"] for e in mine)
    assert {e["name"] for e in mine if e["set"]} == set(env)
    jax_by_name = {e["name"]: e for e in theirs}
    for e in mine:
        j = jax_by_name.get(e["name"])
        if j is not None and e["name"] != "SELDON_TPU_CTX_BUCKETS":
            assert (e["kind"], e["default"], e["zero_off"]) == (j["kind"], j["default"], j["zero_off"]), e["name"]
    for name in ("SELDON_TPU_FAULT", "SELDON_TPU_WATCHDOG_CHUNK_MS", "SELDON_TPU_FORCE_EVACUATE",
                 "SELDON_TPU_NAN_GUARD", "SELDON_TPU_FLIGHT_RECORDER", "SELDON_TPU_DUMP_P99_MS",
                 "SELDON_TPU_TELEMETRY_RING", "SELDON_TPU_PROM_BRIDGE", "SELDON_TPU_CAPTURE_PAYLOADS",
                 "SELDON_TPU_PROFILE_CHUNKS"):
        assert name in jax_by_name and any(e["name"] == name for e in mine)


# ---------------------------------------------------------------------------
# the debug endpoints against the JAX gateway's
# ---------------------------------------------------------------------------

async def _walk(app):
    from aiohttp.test_utils import TestClient, TestServer

    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        resp = await client.post("/api/v0.1/predictions", json={"data": {"ndarray": [PROMPT]},
                                                                  "meta": {"tags": {"max_new_tokens": 6}}})
        answer = await resp.json()
        puid = answer["meta"]["puid"]
        out = {"answer": answer}
        for key, path in (("engine", "/debug/engine"), ("detail", "/debug/engine?detail=1"),
                          ("traces", f"/debug/traces?trace_id={puid}"), ("knobs", "/debug/knobs"),
                          ("weights", "/debug/weights"), ("telemetry", "/debug/telemetry?window=60"),
                          ("request", f"/debug/request/{puid}"), ("missing", "/debug/request/nobody")):
            resp = await client.get(path)
            out[key] = (resp.status, await resp.json())
        resp = await client.get("/metrics", headers={"Accept": "application/openmetrics-text; version=1.0.0"})
        out["metrics"] = (resp.headers.get("Content-Type", ""), await resp.text())
        return out
    finally:
        await client.close()


@pytest.fixture(scope="module")
def walks(tmp_path_factory):
    cap_dir = str(tmp_path_factory.mktemp("captures"))
    before = (tracing._tracer, jax_tracing._tracer)
    tracing.setup_tracing("port")
    jax_tracing.setup_tracing("jax")
    try:
        with _env(SELDON_TPU_CAPTURE="1", SELDON_TPU_CAPTURE_SAMPLE="1", SELDON_TPU_CAPTURE_DIR=cap_dir):
            capture.reset_default_store()
            jax_capture.reset_default_store()
            lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=6, **CFG, **ENGINE)
            jax_lm = jax_paged.StreamingLM(max_new_tokens=6, **CFG, **ENGINE)
            lm.load()
            jax_lm.load()
            try:
                mine = asyncio.run(_walk(server.build_gateway_app(server.Gateway(
                    [(PredictorService(UnitSpec(name="lm", type="MODEL", component=lm), name="main"), 1.0)]))))
                theirs = asyncio.run(_walk(jax_server.build_gateway_app(jax_server.Gateway(
                    [(JaxPredictorService(JaxUnitSpec(name="lm", type="MODEL", component=jax_lm), name="main"),
                      1.0)]))))
            finally:
                lm.unload()
                jax_lm.shutdown()
    finally:
        tracing._tracer, jax_tracing._tracer = before
        capture.reset_default_store()
        jax_capture.reset_default_store()
    return mine, theirs


def test_debug_engine_shape(walks):
    mine, theirs = walks
    for w in (mine, theirs):
        assert w["engine"][0] == w["detail"][0] == 200 and list(w["detail"][1]) == ["main"]
        assert list(w["detail"][1]["main"]) == ["lm"]
    extra = [set(w["detail"][1]["main"]["lm"]) - set(w["engine"][1]["main"]["lm"]) for w in (mine, theirs)]
    assert extra[0] == extra[1] == {"watchdog", "recorder", "recorder_stats"}
    m, t = mine["detail"][1]["main"]["lm"], theirs["detail"][1]["main"]["lm"]
    assert set(m["watchdog"]) == set(t["watchdog"]) and set(m["recorder_stats"]) == set(t["recorder_stats"])
    assert m["recorder"] and set(m["recorder"][-1]) == set(t["recorder"][-1])
    shared = set(m) & set(t)
    assert {"health", "health_state", "watchdog_trips", "quarantined", "chunk_faults", "captures",
            "cost_page_seconds", "cost_by_adapter", "capture_store_bytes"} <= shared


def test_debug_traces_knobs_weights_shape(walks):
    mine, theirs = walks
    for key in ("traces", "knobs", "weights"):
        assert mine[key][0] == theirs[key][0] == 200
        assert set(mine[key][1]) == set(theirs[key][1]), key
    spans = [w["traces"][1]["spans"] for w in (mine, theirs)]
    assert set(spans[0][0]) == set(spans[1][0])
    gen = [{s["name"] for s in sp if s["name"].startswith("gen.")} for sp in spans]
    assert gen[0] == gen[1] == {"gen.queued", "gen.prefill", "gen.decode", "gen.finish"}
    assert {tuple(sorted(e)) for e in mine["knobs"][1]["knobs"]} == {
        tuple(sorted(e)) for e in theirs["knobs"][1]["knobs"]}
    assert {"SELDON_TPU_CAPTURE", "SELDON_TPU_CAPTURE_SAMPLE"} <= set(mine["knobs"][1]["set"])
    assert mine["weights"][1]["engines"].keys() == theirs["weights"][1]["engines"].keys()


def test_debug_telemetry_and_request_shape(walks):
    from seldon_core_tpu.utils.telemetry import validate_snapshot as jax_validate
    from seldon_core_tpu_torch.utils.telemetry import validate_snapshot

    mine, theirs = walks
    m, t = mine["telemetry"][1], theirs["telemetry"][1]
    assert set(m) == set(t) and set(m["latest"]) == set(t["latest"])
    validate_snapshot(t)
    jax_validate(m)
    assert mine["request"][0] == theirs["request"][0] == 200
    m, t = mine["request"][1], theirs["request"][1]
    assert set(m) == set(t) and set(m["capture"]) == set(t["capture"])
    assert set(m["timeline"][0]) <= {"t", "event", "source", "duration_ms"}
    assert m["capture"]["tokens"] == mine["answer"]["data"]["ndarray"][0]
    assert mine["missing"][0] == theirs["missing"][0] == 404 and set(mine["missing"][1]) == set(theirs["missing"][1])


def test_metrics_scrape_negotiates_openmetrics(walks):
    mine, _theirs = walks
    ctype, text = mine["metrics"]
    assert ctype.startswith("application/openmetrics-text") and text.endswith("# EOF\n")
    assert "seldon_tpu_engine_tokens_total" in text


# ---------------------------------------------------------------------------
# the off lane
# ---------------------------------------------------------------------------

def test_off_lane_serves_the_same_tokens_and_sheds_the_new_keys():
    lanes = {}
    for lane, env in (("on", {}), ("off", OFF_LANE)):
        with _env(**env):
            lm = StreamingLM(device="cpu", dtype="float32", max_new_tokens=6, **CFG, **ENGINE)
            lm.load()
            try:
                rows = lm.predict(np.asarray([PROMPT]), [], meta={"tags": {"seed": 1}})
                lanes[lane] = (rows, lm.engine.engine_stats(), lm.custom_routes(),
                               [r.resource.canonical for r in rest.build_app(lm).router.routes()],
                               lm.tags())
            finally:
                lm.unload()
    np.testing.assert_array_equal(lanes["on"][0], lanes["off"][0])
    on_keys, off_keys = set(lanes["on"][1]), set(lanes["off"][1])
    assert not any(k.startswith(("cost_", "capture")) for k in off_keys)
    assert {"cost_page_seconds", "cost_by_adapter"} <= on_keys and lanes["on"][4]["cost"]["decode_tokens"] == 6
    assert lanes["off"][4] == {}
    assert "/debug/telemetry" in lanes["on"][2] and lanes["off"][2] == {}
    assert "/debug/telemetry" in lanes["on"][3] and "/debug/telemetry" not in lanes["off"][3]
    # the off lane's tokens are the JAX engine's (one flax init, f32), and
    # the keys it keeps are the JAX engine's on its off lane
    flax = FlaxTransformerLM(dtype=jnp.float32, **CFG).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))
    prompts = [np.asarray(PROMPT, np.int32), np.arange(5, 30, dtype=np.int32) % CFG["vocab_size"]]
    with _env(**OFF_LANE):
        port = PagedEngine(lm_params_from_flax(flax["params"]), dtype="float32", device="cpu", **CFG, **ENGINE)
        jax_eng = jax_paged.PagedEngine(flax["params"], dtype=jnp.float32, **CFG, **ENGINE)
        mine = [port.submit(p, max_new_tokens=10) for p in prompts]
        theirs = [jax_eng.submit(p, max_new_tokens=10) for p in prompts]
        port.run()
        jax_eng.run()
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a.result, b.result)
    jax_off = set(jax_eng.engine_stats())
    assert {"health", "health_state", "watchdog_trips", "quarantined", "chunk_faults"} <= jax_off
    assert not any(k.startswith(("cost_", "capture")) for k in jax_off | set(port.engine_stats()))
