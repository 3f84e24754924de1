"""Stepping one ``PagedEngine`` from two threads at once.

``StreamingLM``'s decode loop steps its engine whenever it has work;
``PagedEngine.generate`` steps the same engine from the caller's thread.
Here a churn thread keeps submitting streams to a served engine and
waking its loop while the test thread calls ``generate`` on that engine
again and again, with a short interpreter switch interval so the two
threads interleave.  Every call, and every churn stream, must give the
greedy tokens of an unserved engine of the same config and seed, token
for token in float32.
"""

import sys
import threading

import numpy as np

from seldon_core_tpu_torch.models.generate import load_lm_params
from seldon_core_tpu_torch.models.paged import PagedEngine, StreamingLM

CFG = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=2, max_len=128)
ENGINE = dict(page_size=8, max_slots=4, steps_per_call=4)
SEED = 11
MAX_NEW = 8
CHURN_STREAMS = 24
CHURN_IN_FLIGHT = 3
ROUNDS = 3


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(0, CFG["vocab_size"], size=(n,)).astype(np.int32) for n in (5, 13, 21, 9)]


def test_generate_on_a_served_engine_equals_an_unserved_engine():
    prompts = _prompts()
    alone = PagedEngine(load_lm_params("", CFG, SEED), dtype="float32", device="cpu", **CFG, **ENGINE)
    want = [alone.generate(p, max_new_tokens=MAX_NEW).tolist() for p in prompts]

    lm = StreamingLM(device="cpu", dtype="float32", seed=SEED, **CFG, **ENGINE)
    lm.load()
    churned, errors = [], []

    def churn():
        try:
            in_flight = []
            for i in range(CHURN_STREAMS):
                if len(in_flight) >= CHURN_IN_FLIGHT:
                    assert in_flight.pop(0).event.wait(timeout=60), "a churn stream never finished"
                stream = lm.engine.submit(prompts[i % len(prompts)], max_new_tokens=MAX_NEW)
                churned.append((i % len(prompts), stream))
                in_flight.append(stream)
                lm._wake.set()
        except Exception as e:  # noqa: BLE001 — re-raised on the test thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    thread = threading.Thread(target=churn, name="churn")
    try:
        thread.start()
        got = [[lm.engine.generate(p, max_new_tokens=MAX_NEW).tolist() for p in prompts] for _ in range(ROUNDS)]
        thread.join(timeout=120)
        assert not thread.is_alive(), "the churn thread did not finish"
        for _, stream in churned:
            assert stream.event.wait(timeout=60), "a churn stream never finished"
    finally:
        sys.setswitchinterval(interval)
        lm.unload()
    assert not errors, errors
    assert got == [want] * ROUNDS
    assert [s.result.tolist() for _, s in churned] == [want[i] for i, _ in churned]
