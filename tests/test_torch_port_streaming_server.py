"""The port's ``StreamingLM`` served by its microservice CLI over REST.

A tiny float32 config on ``device=cpu`` with the kernel lane forced
(its plain version on the CPU), started as a subprocess the way a user
starts it.  Concurrent predicts with different prompt lengths must each
return ``max_new_tokens`` ids, a repeated greedy request must return the
same ids, and every served row must equal the in-process engine's row
for the same prompt submitted alone (same seed, same weights).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=2, steps_per_call=4)
MAX_NEW = 6
SEED = 3


def _params():
    ints = {**CFG, **ENGINE, "max_new_tokens": MAX_NEW, "seed": SEED}
    out = [{"name": k, "value": str(v), "type": "INT"} for k, v in ints.items()]
    return out + [{"name": "device", "value": "cpu", "type": "STRING"},
                  {"name": "dtype", "value": "float32", "type": "STRING"}]


def _post(base, body, timeout=120):
    req = urllib.request.Request(base + "/predict", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=timeout).read())


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, CFG["vocab_size"], size=(n,)).tolist()


@pytest.fixture(scope="module")
def server():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, SELDON_TPU_PAGED_KERNEL="force")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_core_tpu_torch.runtime.microservice",
         "seldon_core_tpu_torch.models.paged.StreamingLM", "--api", "REST", "--host", "127.0.0.1",
         "--http-port", str(port), "--parameters", json.dumps(_params())],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                urllib.request.urlopen(base + "/health/ping", timeout=2).read()
                break
            except OSError:
                assert time.time() < deadline, "CLI did not start serving"
                time.sleep(0.3)
        yield base
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


@pytest.fixture(scope="module")
def local_rows():
    """The in-process engine, each prompt submitted alone."""
    eng = PagedEngine(load_lm_params("", CFG, SEED), dtype="float32", device="cpu", **CFG, **ENGINE)

    def row(prompt):
        return eng.generate(np.asarray(prompt), max_new_tokens=MAX_NEW).tolist()

    return row


def test_concurrent_ragged_prompts(server, local_rows):
    lengths = [3, 9, 17, 30, 5]
    prompts = [_prompt(n, i) for i, n in enumerate(lengths)]
    out = [None] * len(prompts)

    def send(i):
        out[i] = _post(server, {"data": {"ndarray": [prompts[i]]}})

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for prompt, body in zip(prompts, out):
        rows = np.asarray(body["data"]["ndarray"])
        assert rows.shape == (1, MAX_NEW)
        assert ((rows >= 0) & (rows < CFG["vocab_size"])).all()
        assert rows[0].tolist() == local_rows(prompt)


def test_greedy_repeat_is_identical_and_tags_override(server):
    body = {"data": {"ndarray": [_prompt(11, 42)]}}
    first = _post(server, body)["data"]["ndarray"]
    assert _post(server, body)["data"]["ndarray"] == first
    longer = _post(server, {**body, "meta": {"tags": {"max_new_tokens": 9}}})["data"]["ndarray"]
    assert len(longer[0]) == 9 and longer[0][:MAX_NEW] == first[0]


def test_health_status_reports_the_kernel_lane(server):
    status = json.loads(urllib.request.urlopen(server + "/health/status", timeout=30).read())["jsonData"]
    assert status["loaded"] is True and status["device"] == "cpu"
    assert status["kernel_active"] is True
    assert set(status["kernel_launches"]) >= {"paged_decode_stream", "paged_decode_grid"}
    assert status["engine"]["chunks"] > 0
    metrics = urllib.request.urlopen(server + "/metrics", timeout=30).read().decode()
    assert "paged_kernel_active 1.0" in metrics
    assert 'streaminglm_kernel_launches{kernel="paged_decode_stream"}' in metrics


def test_load_is_idempotent_and_unload_stops_the_loop():
    lm = StreamingLM(device="cpu", dtype="float32", **CFG, **ENGINE)
    lm.load()
    engine, thread = lm.engine, lm._loop_thread
    lm.load()
    assert lm.engine is engine and lm._loop_thread is thread
    out = lm.predict(np.asarray([_prompt(12, 1), _prompt(12, 2)]), [], meta={"tags": {"max_new_tokens": 3}})
    assert out.shape == (2, 3)
    lm.unload()
    assert not thread.is_alive()
