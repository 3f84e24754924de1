"""C15: ``DynamicBatcher.submit_lent`` bounds the native lane's wait
without ever letting the batcher read rows the caller has freed.

The native ingress lends ``raw_batch_call`` a view of C++ memory that is
freed when the call returns.  The reference gives up after 120 s
(``seldon_core_tpu/models/jaxserver.py:666``); the port does too, and on
timeout either cancels a still-queued request, whose rows the collector
then never reads, or waits until ``predict_fn`` has returned for the
batch that holds it.  A ``predict_fn`` that blocks on an event stands in
for a wedged device; every test takes a second or two at most.
"""

import threading
import time

import numpy as np
import pytest

from seldon_core_tpu_torch.batching.batcher import DynamicBatcher

FREED = 255  # what a freed C++ buffer is overwritten with here


class BlockingModel:
    """Records every batch it is given (a copy, as the staging copy is)
    and blocks while ``gate`` is clear."""

    def __init__(self):
        self.gate = threading.Event()
        self.entered = threading.Event()
        self.returned = threading.Event()
        self.batches = []

    def __call__(self, batch):
        self.batches.append(np.array(batch, copy=True))
        self.entered.set()
        self.gate.wait(5.0)
        self.returned.set()
        return batch.astype(np.float32) * 2.0


def _batcher(model, max_batch_size=4, max_wait_ms=1.0):
    return DynamicBatcher(model, max_batch_size=max_batch_size, max_wait_ms=max_wait_ms, name="c15",
                          finisher_threads=1)


def _lend_and_free(batcher, rows, timeout_s):
    """submit_lent as the native lane calls it, then 'free' the buffer."""
    try:
        return batcher.submit_lent(rows, timeout_s=timeout_s)
    finally:
        rows[...] = FREED


def _wait_for(cond, timeout_s=5.0):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        assert time.perf_counter() < deadline, "timed out waiting for the batcher"
        time.sleep(0.002)


@pytest.mark.parametrize("carried", [False, True], ids=["queued", "carried"])
def test_timed_out_queued_request_is_never_read(carried):
    """The collector is stuck in predict_fn for batch A; request B waits
    behind it, in the queue or in the carry slot (B would overflow A's
    batch).  B times out, its buffer is freed, the device recovers: no
    batch ever holds B's rows or the freed bytes."""
    model = BlockingModel()
    # a long window holds A's batch open until B arrives and is carried
    with _batcher(model, max_batch_size=2, max_wait_ms=2000.0 if carried else 1.0) as b:
        a_rows = np.full((1 if carried else 2, 3), 7, np.uint8)
        fut_a = b.submit_future(a_rows)
        if carried:
            _wait_for(lambda: b._queue.qsize() == 0)  # A taken: the window is open
        else:
            assert model.entered.wait(5.0)
        b_rows = np.full((2, 3), 9, np.uint8)
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            _lend_and_free(b, b_rows, timeout_s=0.25)
        waited = time.perf_counter() - t0
        assert waited < 1.0, waited  # a queued request does not wait for the device
        assert model.entered.is_set() and (b._carry is not None) == carried
        assert not model.returned.is_set()
        model.gate.set()
        np.testing.assert_array_equal(fut_a.result(timeout=5.0), a_rows.astype(np.float32) * 2.0)
        # the batcher keeps serving after the cancelled request
        c_rows = np.full((2, 3), 5, np.uint8)  # a full batch: no window to wait out
        np.testing.assert_array_equal(b.submit_lent(c_rows, timeout_s=5.0), c_rows.astype(np.float32) * 2.0)
    seen = np.concatenate([x.reshape(-1) for x in model.batches])
    assert not np.isin(seen, [9, FREED]).any(), [x.tolist() for x in model.batches]


def test_timed_out_collected_request_waits_for_predict_fn():
    """B is already in the batch that predict_fn holds: submit_lent
    raises TimeoutError only after predict_fn has returned, so the rows
    were staged before the caller frees them."""
    model = BlockingModel()
    with _batcher(model) as b:
        rows = np.full((1, 3), 4, np.uint8)
        threading.Timer(0.5, model.gate.set).start()
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            _lend_and_free(b, rows, timeout_s=0.25)
        waited = time.perf_counter() - t0
        assert model.returned.is_set(), "TimeoutError raised while predict_fn still held the rows"
        assert 0.45 <= waited < 5.0, waited
    assert len(model.batches) == 1 and (model.batches[0][:1] == 4).all()


def test_submit_lent_answers_within_its_bound():
    model = BlockingModel()
    model.gate.set()
    with _batcher(model) as b:
        rows = np.arange(6, dtype=np.uint8).reshape(2, 3)
        np.testing.assert_array_equal(b.submit_lent(rows, timeout_s=2.0), rows.astype(np.float32) * 2.0)


def test_stop_releases_a_waiting_lent_request():
    """stop() fails a never-launched lent request and releases it, so its
    caller returns (with the stop error) instead of hanging."""
    model = BlockingModel()
    b = _batcher(model, max_batch_size=1)
    b.start()
    b.submit_future(np.zeros((1, 3), np.uint8))
    assert model.entered.wait(5.0)
    errors = []

    def lend():
        try:
            b.submit_lent(np.ones((1, 3), np.uint8), timeout_s=5.0)
        except Exception as e:  # noqa: BLE001 — recorded for the assertion
            errors.append(e)

    t = threading.Thread(target=lend)
    t.start()
    _wait_for(lambda: b._queue.qsize() == 1)  # the lent request is queued behind the stuck batch
    stopper = threading.Thread(target=b.stop)
    stopper.start()
    _wait_for(lambda: not b._running)
    model.gate.set()
    stopper.join(5.0)
    t.join(5.0)
    assert not t.is_alive() and len(errors) == 1 and "stopped" in str(errors[0])


def test_raw_batch_call_passes_its_bound_to_the_batcher():
    """CudaServer.raw_batch_call / raw_batch_views time out as the
    reference does (120 s by default) through submit_lent."""
    import inspect

    from seldon_core_tpu_torch.models.cudaserver import CudaServer

    for fn in (CudaServer.raw_batch_call, CudaServer.raw_batch_views):
        assert inspect.signature(fn).parameters["timeout_s"].default == 120.0
    server = CudaServer(model="resnet_tiny", device="cpu", max_batch_size=2, input_shape=[8, 8, 3],
                        num_classes=4)
    server.load()
    try:
        calls = []
        real = server.batcher.submit_lent

        def spy(x, timeout_s):
            calls.append(timeout_s)
            return real(x, timeout_s=timeout_s)

        server.batcher.submit_lent = spy
        out = server.raw_batch_call(np.zeros((2, 192), np.uint8), timeout_s=7.5)
        server.raw_batch_views([np.zeros((1, 192), np.uint8)], timeout_s=3.0)
        assert out.shape == (2, 4) and calls == [7.5, 3.0]
    finally:
        server.unload()


def test_a_cancelled_request_does_not_fail_its_batch():
    """C17: a request its caller cancelled after the batch was collected
    (a hedge loser whose RPC was cancelled, a client gone) is dropped
    when the batch's rows come back; the requests after it in the batch
    still get their own rows.  The JAX batcher fails them with the
    cancelled future's InvalidStateError."""
    model = BlockingModel()
    with _batcher(model, max_wait_ms=200.0) as b:
        first, second = np.full((1, 3), 1, np.uint8), np.full((2, 3), 2, np.uint8)
        cancelled, kept = b.submit_future(first), b.submit_future(second)
        assert model.entered.wait(5.0)
        assert cancelled.cancel()
        model.gate.set()
        np.testing.assert_array_equal(kept.result(timeout=5.0), second.astype(np.float32) * 2.0)
    assert cancelled.cancelled()
    assert len(model.batches) == 1  # one batch held both, padded to its bucket
    np.testing.assert_array_equal(model.batches[0][:3], np.concatenate([first, second]))
