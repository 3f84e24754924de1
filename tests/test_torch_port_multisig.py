"""A6: the port's ``MultiSignatureBatcher`` and ``CudaServer(extra_input_shapes=...)``
against the JAX package's.

* The batcher: the same scripts drive the port's class and JAX's
  (``seldon_core_tpu/batching/batcher.py``) over a numpy model: the
  groups formed, the answers, the cap's error, the summed stats and
  ``stop``.  Requests are sent one at a time where counts are compared,
  so each is its own batch on both sides.
* What the port adds: ``submit_lent`` routed to the rows' group, with
  C15's bound (a queued lent request that times out is never read) and
  C17 (a cancelled request drops out of its batch) inside a group.
* The server: the vit_tiny 32 + 48 server of
  ``tests/test_jaxserver.py::test_multi_resolution_through_jaxserver_signatures``
  against ``JaxServer`` on the same flax variables, float32 logits within
  rtol = atol = 1e-4 (C2: never bit-equality across batch shapes);
  ``_prepare``'s shape precedence case for case against
  ``JaxServer._prepare``; warmup over shapes × buckets × dtypes; the
  summed ``/metrics`` series; and the microservice CLI taking
  ``model_uri``, ``extra_input_shapes`` and ``model_kwargs`` as typed
  parameters, as a user starts it.
"""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_core_tpu.batching.batcher import MultiSignatureBatcher as JaxMultiSignatureBatcher
from seldon_core_tpu.models.jaxserver import JaxServer
from seldon_core_tpu.models.vit import ViTTiny as FlaxViTTiny
from seldon_core_tpu.runtime import MicroserviceError as JaxMicroserviceError
from seldon_core_tpu_torch.batching.batcher import MultiSignatureBatcher
from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.runtime import MicroserviceError

TOL = dict(rtol=1e-4, atol=1e-4)
NUM_CLASSES = 10


def model(batch):
    """Per row: the sum of its elements, twice, as float32 (row order kept)."""
    return (np.asarray(batch).reshape(batch.shape[0], -1).astype(np.float64).sum(-1) * 2).astype(np.float32)


def _script(cls):
    """One run of the reference script: answers, groups, the cap's error,
    the summed stats, then stop."""
    b = cls(model, max_batch_size=4, max_wait_ms=0.5, name="ms", max_signatures=4, finisher_threads=1)
    b.start()
    rng = np.random.default_rng(0)
    answers = []
    for x in (rng.integers(0, 9, (2, 3)).astype(np.float32), rng.integers(0, 9, (1, 4)).astype(np.float32),
              rng.integers(0, 9, (3, 3)).astype(np.uint8), rng.integers(0, 9, (1, 3)).astype(np.float32),
              rng.integers(0, 9, (2, 2, 2)).astype(np.float32)):
        answers.append(b.submit(x, timeout_s=5.0).tolist())
    with pytest.raises(ValueError, match="max_signatures=4") as cap:
        b.submit(np.zeros((1, 7), np.float32))
    with pytest.raises(ValueError, match="leading batch dimension"):
        b.submit_future(np.float32(1.0))
    stats = b.stats
    out = dict(answers=answers, signatures=b.signatures, cap=str(cap.value),
               stats=(stats.requests, stats.batches, stats.rows, stats.padded_rows, len(stats.total_ms)),
               buckets=b.buckets)
    b.stop()
    with pytest.raises(RuntimeError, match="not started"):
        b.submit(np.zeros((1, 3), np.float32))
    b.start()  # a restart starts every group again
    out["restarted"] = b.submit(np.ones((1, 3), np.float32), timeout_s=5.0).tolist()
    b.stop()
    return out


def test_groups_cap_stats_and_stop_match_jax():
    port, ref = _script(MultiSignatureBatcher), _script(JaxMultiSignatureBatcher)
    assert port == ref
    assert port["signatures"] == [("<f4", (2, 2)), ("<f4", (3,)), ("<f4", (4,)), ("|u1", (3,))]
    assert port["stats"][:3] == (5, 5, 9)


def test_the_stats_sum_the_windows_sums_over_groups():
    b = MultiSignatureBatcher(model, max_batch_size=2, max_wait_ms=0.5, name="sum", finisher_threads=1)
    with b:
        for shape in ((1, 3), (1, 4), (2, 3)):
            b.submit(np.ones(shape, np.float32), timeout_s=5.0)
        stats = b.stats
        groups = list(b._groups.values())
        assert stats.collect_ms_total == pytest.approx(sum(g.stats.collect_ms_total for g in groups))
        assert stats.total_ms_sum == pytest.approx(sum(g.stats.total_ms_sum for g in groups)) and stats.total_ms_sum > 0
        assert stats.mean_batch_rows == pytest.approx(4 / 3)


def test_signatures_coalesce_apart():
    """Concurrent requests of two signatures: each group batches its own
    rows; no batch mixes them."""
    seen = []

    def record(batch):
        seen.append(batch.shape)
        return model(batch)

    with MultiSignatureBatcher(record, max_batch_size=8, max_wait_ms=50.0, name="apart") as b:
        futs = [b.submit_future(np.full((1, 3 + i % 2), i, np.float32)) for i in range(8)]
        got = [f.result(timeout=5.0) for f in futs]
    assert [g.tolist() for g in got] == [[2.0 * i * (3 + i % 2)] for i in range(8)]
    assert sorted(set(s[1:] for s in seen)) == [(3,), (4,)] and sum(s[0] for s in seen) >= 8


# ---------------------------------------------------------------------------
# submit_lent: routing, C15 and C17 inside a group
# ---------------------------------------------------------------------------

class Gate:
    """A model that blocks on ``gate`` for its first batch and records
    every batch (a copy, as the staging copy is)."""

    def __init__(self):
        self.gate, self.entered, self.batches = threading.Event(), threading.Event(), []

    def __call__(self, batch):
        self.batches.append(np.array(batch, copy=True))
        self.entered.set()
        self.gate.wait(5.0)
        return model(batch)


def test_submit_lent_goes_to_the_rows_group():
    with MultiSignatureBatcher(model, max_batch_size=4, max_wait_ms=0.5, name="lent") as b:
        a = b.submit_lent(np.ones((2, 3), np.uint8), timeout_s=5.0)
        c = b.submit_lent(np.ones((1, 5), np.float32), timeout_s=5.0)
        assert a.tolist() == [6.0, 6.0] and c.tolist() == [10.0]
        groups = b._groups
        assert sorted(groups) == [("<f4", (5,)), ("|u1", (3,))]
        assert groups[("|u1", (3,))].stats.requests == 1 and groups[("<f4", (5,))].stats.requests == 1


def test_a_timed_out_lent_request_in_a_group_is_never_read():
    """C15 in a group: the group's collector is stuck in the model with
    batch A; lent request B, queued behind it, times out and its buffer
    is freed; no batch ever holds B's rows.  The other group serves on."""
    gated = Gate()
    with MultiSignatureBatcher(gated, max_batch_size=2, max_wait_ms=1.0, name="c15", finisher_threads=1) as b:
        fut_a = b.submit_future(np.full((2, 3), 7, np.uint8))
        assert gated.entered.wait(5.0)
        rows = np.full((2, 3), 9, np.uint8)
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            try:
                b.submit_lent(rows, timeout_s=0.25)
            finally:
                rows[...] = 255
        assert time.perf_counter() - t0 < 1.0
        gated.gate.set()
        assert fut_a.result(timeout=5.0).tolist() == [42.0, 42.0]
        assert b.submit_lent(np.full((2, 4), 1, np.float32), timeout_s=5.0).tolist() == [8.0, 8.0]
    seen = np.concatenate([x.reshape(-1) for x in gated.batches if x.dtype == np.uint8])
    assert not np.isin(seen, [9, 255]).any()


def test_a_cancelled_request_drops_out_of_its_groups_batch():
    """C17 in a group: a request cancelled after its batch was collected
    is dropped when the rows come back; its batch-mate gets its answer."""
    gated = Gate()
    with MultiSignatureBatcher(gated, max_batch_size=4, max_wait_ms=200.0, name="c17") as b:
        first, second = np.full((1, 3), 1, np.float32), np.full((2, 3), 2, np.float32)
        cancelled, kept = b.submit_future(first), b.submit_future(second)
        assert gated.entered.wait(5.0)
        assert cancelled.cancel()
        gated.gate.set()
        assert kept.result(timeout=5.0).tolist() == [12.0, 12.0]
    assert cancelled.cancelled() and len(gated.batches) == 1


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_pair():
    variables = FlaxViTTiny(num_classes=NUM_CLASSES, dtype=jnp.float32).init(
        jax.random.key(3), jnp.zeros((1, 32, 32, 3), jnp.float32))
    common = dict(model="vit_tiny", num_classes=NUM_CLASSES, input_shape=(32, 32, 3),
                  extra_input_shapes=[(48, 48, 3)], dtype="float32", max_batch_size=4,
                  warmup_dtypes=("float32", "uint8"), normalize=True)
    js = JaxServer(warmup=False, **common)
    js.load()
    js.variables = jax.device_put(variables)
    cs = CudaServer(device="cpu", variables=variables, warmup=True, **common)
    cs.load()
    yield js, cs
    js.unload()
    cs.unload()


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_vit_two_resolutions_match_jaxserver(vit_pair, dtype):
    js, cs = vit_pair
    rng = np.random.default_rng(1 if dtype == "uint8" else 2)
    for shape in ((32, 32, 3), (48, 48, 3)):
        x = rng.integers(0, 256, (3, *shape)).astype(dtype)
        want, got = np.asarray(js.predict(x, [])), np.asarray(cs.predict(x, []))
        assert got.shape == want.shape == (3, NUM_CLASSES)
        np.testing.assert_allclose(got, want, **TOL)
    assert isinstance(cs.batcher, MultiSignatureBatcher)
    assert {shape for _, shape in cs.batcher.signatures} == {(32, 32, 3), (48, 48, 3)}


def test_vit_groups_warmup_status_and_metrics(vit_pair):
    _, cs = vit_pair
    assert cs.accepted_shapes() == [(32, 32, 3), (48, 48, 3)]
    # warmup went through device_call directly: every shape x bucket x dtype
    status = cs.health_status()
    assert status["signatures"] == [[32, 32, 3], [48, 48, 3]]
    groups = status["signature_groups"]
    assert all(len(g) == 2 for g in groups)
    before = cs.batcher.stats.batches
    cs.predict(np.zeros((1, 48, 48, 3), np.uint8), [])
    cs.predict(np.zeros((2, 32, 32, 3), np.uint8), [])
    metrics = {m["key"]: m["value"] for m in cs.metrics() if not m.get("tags")}
    assert metrics["cudaserver_batches_total"] == before + 2 == sum(g.stats.batches for g in cs.batcher._groups.values())


def test_vit_refuses_a_third_resolution_naming_both(vit_pair):
    js, cs = vit_pair
    x = np.zeros((1, 40, 40, 3), np.uint8)
    with pytest.raises(MicroserviceError) as err:
        cs.predict(x, [])
    with pytest.raises(JaxMicroserviceError) as jerr:
        js.predict(x, [])
    assert err.value.status_code == jerr.value.status_code == 400
    assert err.value.reason == jerr.value.reason == "BAD_INPUT_SHAPE"
    assert str(err.value) == str(jerr.value)
    assert "(batch, 32, 32, 3) | (batch, 48, 48, 3)" in str(err.value)


def _preparers(shapes, dtypes=("float32", "uint8")):
    """A JaxServer and a CudaServer whose ``_prepare`` sees the given
    signatures (marked loaded: ``_prepare`` reads only the signatures and
    the dtypes)."""
    out = []
    for cls, kw in ((JaxServer, {}), (CudaServer, {"device": "cpu"})):
        s = cls(model="resnet_tiny", input_shape=shapes[0], extra_input_shapes=shapes[1:], warmup_dtypes=dtypes,
                **kw)
        s._loaded = True
        out.append(s)
    return out


PREPARE_CASES = {
    "batch_reading_wins": ((16, 16), np.float32),    # 16 rows of (16,), not one (16, 16)
    "explicit_batch_of_one": ((1, 16, 16), np.float32),
    "single_example": ((16,), np.float32),
    "flat_rows_first_match": ((3, 256), np.float32),  # (16, 16) is the first signature of 256
    "flat_rows_of_the_primary": ((3, 16), np.uint8),
    "float64_cast": ((2, 16), np.float64),
    "int_cast": ((16,), np.int64),
    "no_match": ((2, 5), np.float32),
    "no_match_3d": ((2, 16, 15), np.float32),
}


@pytest.mark.parametrize("case", list(PREPARE_CASES))
def test_prepare_precedence_matches_jaxserver(case):
    shape, dtype = PREPARE_CASES[case]
    js, cs = _preparers([(16,), (16, 16)])
    x = np.arange(int(np.prod(shape))).reshape(shape).astype(dtype)
    try:
        want = js._prepare(x)
    except JaxMicroserviceError as e:
        with pytest.raises(MicroserviceError) as err:
            cs._prepare(x)
        assert (err.value.status_code, err.value.reason, str(err.value)) == (e.status_code, e.reason, str(e))
        assert "(batch, 16) | (batch, 16, 16)" in str(err.value)
        return
    got = cs._prepare(x)
    assert got[1] == want[1]
    assert got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


def test_a_third_signature_beyond_the_cap_is_refused_by_the_batcher():
    b = MultiSignatureBatcher(model, max_batch_size=2, name="cap", max_signatures=1)
    with b:
        b.submit(np.ones((1, 2), np.float32))
        with pytest.raises(ValueError, match=r"seen: \[\('<f4', \(2,\)\)\]"):
            b.submit(np.ones((1, 2), np.uint8))


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _post(base, arr):
    body = {"data": {"rawTensor": {"shape": list(arr.shape), "dtype": arr.dtype.name,
                                   "data": base64.b64encode(arr.tobytes()).decode("ascii")}}}
    req = urllib.request.Request(base + "/predict", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_the_cli_serves_a_checkpoint_at_two_resolutions(tmp_path):
    """The CLI with ``model_uri`` (a flax msgpack file), ``extra_input_shapes``
    and ``model_kwargs`` ``pos_grid`` as typed parameters: both resolutions
    answer as the in-process server on the same checkpoint does, and a
    third is a 400 naming both."""
    from flax import serialization

    variables = FlaxViTTiny(num_classes=NUM_CLASSES, dtype=jnp.float32).init(
        jax.random.key(9), jnp.zeros((1, 32, 32, 3), jnp.float32))
    ckpt = tmp_path / "vit.msgpack"
    ckpt.write_bytes(serialization.to_bytes(jax.tree_util.tree_map(np.asarray, dict(variables))))
    params = [{"name": "model", "value": "vit_tiny", "type": "STRING"},
              {"name": "num_classes", "value": str(NUM_CLASSES), "type": "INT"},
              {"name": "dtype", "value": "float32", "type": "STRING"},
              {"name": "device", "value": "cpu", "type": "STRING"},
              {"name": "max_batch_size", "value": "4", "type": "INT"},
              {"name": "normalize", "value": "true", "type": "BOOL"},
              {"name": "model_uri", "value": f"file://{ckpt}", "type": "STRING"},
              {"name": "input_shape", "value": "[32, 32, 3]", "type": "JSON"},
              {"name": "extra_input_shapes", "value": "[[48, 48, 3]]", "type": "JSON"},
              {"name": "model_kwargs", "value": json.dumps({"pos_grid": 4}), "type": "JSON"}]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
                             "seldon_core_tpu_torch.models.cudaserver.CudaServer", "--api", "REST", "--host",
                             "127.0.0.1", "--http-port", str(port), "--parameters", json.dumps(params)],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    local = CudaServer(device="cpu", model="vit_tiny", num_classes=NUM_CLASSES, dtype="float32", max_batch_size=4,
                       normalize=True, warmup=False, model_uri=str(ckpt), input_shape=(32, 32, 3),
                       extra_input_shapes=[(48, 48, 3)], model_kwargs={"pos_grid": 4})
    local.load()
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                status = json.loads(urllib.request.urlopen(base + "/health/status", timeout=2).read())["jsonData"]
                if status["loaded"]:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "CLI did not start serving"
            time.sleep(0.3)
        assert status["signatures"] == [[32, 32, 3], [48, 48, 3]] and status["model_uri"] == f"file://{ckpt}"
        rng = np.random.default_rng(4)
        for shape in ((32, 32, 3), (48, 48, 3)):
            x = rng.integers(0, 256, (2, *shape)).astype(np.uint8)
            code, body = _post(base, x)
            assert code == 200, body
            raw = body["data"]["rawTensor"]
            got = np.frombuffer(base64.b64decode(raw["data"]), raw["dtype"]).reshape(raw["shape"])
            np.testing.assert_allclose(got, local.predict(x, []), **TOL)
        code, body = _post(base, np.zeros((1, 40, 40, 3), np.uint8))
        assert code == 400 and body["status"]["reason"] == "BAD_INPUT_SHAPE"
        assert "(batch, 32, 32, 3) | (batch, 48, 48, 3)" in body["status"]["info"]
    finally:
        local.unload()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
