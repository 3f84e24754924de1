"""The port's end-to-end deadlines and priorities against the JAX package's.

``seldon_core_tpu_torch/utils/deadlines.py`` and
``seldon_core_tpu/utils/deadlines.py`` read the same carriers with the
same rules: ``extract_ms`` / ``extract_priority`` give equal results
(clamps included) on the same headers, metadata tuples and malformed
values; a tighter enclosing deadline wins in ``activate``; ``inject`` /
``inject_metadata`` write the same keys, floored at 0; a spent budget
raises 504 ``DEADLINE_EXCEEDED`` naming the hop, and nothing active
costs nothing.  Exact agreement throughout.
"""

import time

import pytest

from seldon_core_tpu.utils import deadlines as jax_deadlines
from seldon_core_tpu_torch.runtime.component import MicroserviceError
from seldon_core_tpu_torch.utils import deadlines

CARRIERS = [
    {},
    {"X-Seldon-Deadline-Ms": "250"},
    {"x-seldon-deadline-ms": "250.5"},
    {"X-Seldon-Deadline-Ms": "-5"},
    {"X-Seldon-Deadline-Ms": "1e12"},  # clamped to MAX_DEADLINE_MS
    {"X-Seldon-Deadline-Ms": "nan"},
    {"X-Seldon-Deadline-Ms": "inf"},
    {"X-Seldon-Deadline-Ms": "soon"},
    {"X-Seldon-Priority": "3"},
    {"x-seldon-priority": "2.9"},
    {"X-Seldon-Priority": "99"},  # clamped to MAX_PRIORITY
    {"X-Seldon-Priority": "-99"},
    {"X-Seldon-Priority": "high"},
    [("x-seldon-deadline-ms", "40"), ("x-seldon-priority", "1")],  # gRPC metadata tuples
    [("X-SELDON-DEADLINE-MS", "0"), ("other", "x")],
    None,
]


@pytest.mark.parametrize("carrier", CARRIERS, ids=[str(c) for c in CARRIERS])
def test_extract_equals_jax(carrier):
    assert deadlines.extract_ms(carrier) == jax_deadlines.extract_ms(carrier)
    assert deadlines.extract_priority(carrier) == jax_deadlines.extract_priority(carrier)


def test_constants_equal_jax():
    for name in ("DEADLINE_HEADER", "PRIORITY_HEADER", "ADAPTER_HEADER", "MAX_DEADLINE_MS", "MAX_PRIORITY"):
        assert getattr(deadlines, name) == getattr(jax_deadlines, name), name
    for v in (-100, -15, -1, 0, 7, 15, 16, 10**9):
        assert deadlines.clamp_priority(v) == jax_deadlines.clamp_priority(v)


def test_tighter_deadline_wins_in_both_packages():
    for mod in (deadlines, jax_deadlines):
        with mod.activate_ms(1000.0) as outer:
            with mod.activate_ms(5000.0) as inner:  # looser: the enclosing one stays
                assert inner is outer and mod.current_deadline() is outer
            with mod.activate_ms(10.0) as tight:  # tighter: replaces it inside
                assert mod.current_deadline() is tight and tight.expires_at < outer.expires_at
            assert mod.current_deadline() is outer
        assert mod.current_deadline() is None
        with mod.activate(None) as d, mod.activate_ms(None) as e:
            assert d is None and e is None and mod.current_deadline() is None


def test_inject_writes_the_remaining_budget_floored_at_zero():
    for mod in (deadlines, jax_deadlines):
        assert mod.inject({}) == {} and mod.inject_metadata([("a", "b")]) == [("a", "b")]
        with mod.activate_ms(60_000.0):
            ms = int(mod.inject({})["X-Seldon-Deadline-Ms"])
            assert 59_000 <= ms <= 60_000
            (key, val), = mod.inject_metadata()
            assert key == "x-seldon-deadline-ms" and 59_000 <= int(val) <= 60_000
        with mod.activate(mod.Deadline(expires_at=time.monotonic() - 5.0)):
            assert mod.inject({}) == {"X-Seldon-Deadline-Ms": "0"}
            assert mod.inject_metadata() == [("x-seldon-deadline-ms", "0")]


def test_spent_budget_raises_504_naming_the_hop():
    deadlines.check("anything")  # nothing active: a no-op
    with deadlines.activate_ms(0.0):
        with pytest.raises(MicroserviceError) as err:
            deadlines.check("node 'm' predict (grpc 127.0.0.1:1)")
    with jax_deadlines.activate_ms(0.0):
        with pytest.raises(Exception) as jax_err:
            jax_deadlines.check("node 'm' predict (grpc 127.0.0.1:1)")
    assert err.value.to_status() == jax_err.value.to_status()
    assert err.value.status_code == 504 and err.value.reason == "DEADLINE_EXCEEDED"
    assert "node 'm' predict (grpc 127.0.0.1:1)" in err.value.message


def test_deadline_is_absolute_so_time_decrements_it():
    d = deadlines.Deadline.after_ms(200.0)
    first = d.remaining_ms()
    time.sleep(0.02)
    assert d.remaining_ms() < first and not d.expired
    assert deadlines.Deadline.after_ms(0.0).expired
    assert deadlines.Deadline.after_ms(1e15).remaining_ms() <= deadlines.MAX_DEADLINE_MS
