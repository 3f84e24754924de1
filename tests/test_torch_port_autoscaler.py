"""The port's autoscaler against the JAX package's.

Mirrors ``tests/test_autoscaler.py``: the HPA algorithm and the
multi-metric rule run the port's ``Autoscaler`` and the JAX package's on
the same metric series and the same fake clock, decision for decision;
the replica set spawns the port's microservice with stub workers; the
deployer's hpa wiring serves through a replica and cleans it up; and the
port's device-exclusivity guard (C27) refuses hpa replicas only of a
class that declares ``device_exclusive`` (its card memory is not bounded
by a pool).
"""

import asyncio
import os
import time
import urllib.request

import numpy as np
import pytest

from seldon_core_tpu.controlplane import autoscaler as jax_autoscaler
from seldon_core_tpu_torch.controlplane import autoscaler
from seldon_core_tpu_torch.controlplane.autoscaler import Autoscaler, CounterRateSampler, HpaSpec, ReplicaSet

PACKAGES = {"port": autoscaler, "jax": jax_autoscaler}


class FakeReplicaSet:
    def __init__(self, n=1):
        self.replica_count = n
        self.calls = []

    def scale(self, n):
        self.calls.append(n)
        self.replica_count = n
        return n


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def replay(series, *, current=1, metric_fns=None, **hpa_kwargs):
    """Each package's Autoscaler over one series of (dt, {metric: value})
    steps; returns {package: [(applied, desired, winner, metrics), ...]}."""
    out = {}
    for name, mod in PACKAGES.items():
        clock = FakeClock()
        rs = FakeReplicaSet(current)
        values = {}
        names = [n for n, _, _ in mod.HpaSpec(**hpa_kwargs).metric_specs()]
        fns = {n: (lambda n=n: values[n]) for n in names}
        asc = mod.Autoscaler(rs, mod.HpaSpec(**hpa_kwargs), metric_fn=fns, clock=clock)
        rows = []
        for dt, sample in series:
            clock.advance(dt)
            values.update(sample)
            applied = asc.evaluate_once()
            d = asc.history[-1]
            rows.append((applied, d.desired, d.metric, dict(d.metrics)))
        out[name] = (rows, rs.calls)
    return out


def assert_same_decisions(series, expected_applied, **kwargs):
    got = replay(series, **kwargs)
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["port"][0]] == expected_applied
    return got["port"]


class TestHpaAlgorithm:
    def test_spec_validation(self):
        for mod in PACKAGES.values():
            with pytest.raises(ValueError):
                mod.HpaSpec(min_replicas=3, max_replicas=2, target_qps_per_replica=1)
            with pytest.raises(ValueError):
                mod.HpaSpec()
            hpa = mod.HpaSpec(target_qps_per_replica=1, target_inflight_per_replica=1)
            assert [n for n, _, _ in hpa.metric_specs()] == ["qps", "inflight"]
            with pytest.raises(ValueError):
                mod.HpaSpec(custom_targets={"queue_depth": 0.0})
            with pytest.raises(ValueError):
                mod.HpaSpec(custom_targets={"qps": 5.0})

    def test_from_dict_equals_jax(self):
        d = {"minReplicas": 2, "maxReplicas": 8, "targetQps": 50.0, "customTargets": {"depth": 4},
             "stabilizationWindowSeconds": 12, "targetP95Ms": 30}
        mine, theirs = HpaSpec.from_dict(d), jax_autoscaler.HpaSpec.from_dict(d)
        assert mine.metric_specs() == theirs.metric_specs()
        assert (mine.min_replicas, mine.max_replicas, mine.target, mine.scale_down_stabilization_s) == (
            theirs.min_replicas, theirs.max_replicas, theirs.target, theirs.scale_down_stabilization_s) == (
            2, 8, 50.0, 12.0)

    def test_scale_up_is_immediate(self):
        assert_same_decisions([(0, {"qps": 35.0})], [4], target_qps_per_replica=10.0)

    def test_tolerance_dead_band_holds_steady(self):
        rows, calls = assert_same_decisions([(0, {"qps": 21.0})], [2], current=2, target_qps_per_replica=10.0)
        assert calls == []

    def test_max_clamp(self):
        assert_same_decisions([(0, {"qps": 1000.0})], [4], target_qps_per_replica=10.0, max_replicas=4)

    def test_min_clamp_and_stabilized_scale_down(self):
        rows, calls = assert_same_decisions(
            [(0, {"qps": 35.0}), (5, {"qps": 0.0}), (31, {"qps": 0.0})], [4, 4, 1],
            target_qps_per_replica=10.0, scale_down_stabilization_s=30.0)
        assert calls == [4, 1]

    def test_dip_does_not_drain_warm_replicas(self):
        assert_same_decisions([(0, {"qps": 35.0}), (5, {"qps": 2.0}), (5, {"qps": 38.0})], [4, 4, 4],
                              target_qps_per_replica=10.0, scale_down_stabilization_s=30.0)

    def test_a_long_series_decision_for_decision(self):
        rng = np.random.default_rng(7)
        series = [(float(rng.uniform(0.5, 20.0)), {"qps": float(rng.choice([0.0, 3.0, 12.0, 45.0, 90.0])),
                                                    "inflight": float(rng.choice([0.0, 1.0, 6.0]))})
                  for _ in range(60)]
        got = replay(series, target_qps_per_replica=10.0, target_inflight_per_replica=2.0, max_replicas=6,
                     scale_down_stabilization_s=25.0)
        assert got["port"] == got["jax"]
        assert len({r[0] for r in got["port"][0]}) > 2  # the series moves the count

    def test_counter_rate_sampler(self):
        clock = FakeClock()
        count = {"v": 0}
        rate = CounterRateSampler(lambda: count["v"], clock=clock)
        assert rate() == 0.0
        count["v"] = 50
        clock.advance(5)
        assert rate() == pytest.approx(10.0)
        clock.advance(5)
        assert rate() == 0.0

    def test_gateway_request_count_sums_predictors(self):
        class Svc:
            def __init__(self, n):
                self.stats = {"requests": n}

        class Gw:
            predictors = [Svc(3), Svc(4)]

        assert autoscaler.gateway_request_count(Gw())() == 7.0


class TestMultiMetric:
    def test_max_proposal_wins(self):
        rows, _ = assert_same_decisions([(0, {"qps": 20.0, "p95_ms": 400.0})], [4], current=2,
                                        target_qps_per_replica=10.0, target_p95_ms=200.0)
        assert rows[-1][3] == {"qps": 20.0, "p95_ms": 400.0} and rows[-1][2] == 400.0

    def test_hold_beats_scale_down(self):
        rows, calls = assert_same_decisions([(0, {"qps": 0.0, "inflight": 4.2})], [2], current=2,
                                            target_qps_per_replica=10.0, target_inflight_per_replica=2.0)
        assert calls == []

    def test_custom_metric_scales(self):
        assert_same_decisions([(0, {"qps": 1.0, "queue_depth": 24.0})], [3],
                              target_qps_per_replica=100.0, custom_targets={"queue_depth": 8.0})

    def test_single_callable_rejected_for_multi_target(self):
        with pytest.raises(ValueError, match="dict"):
            Autoscaler(FakeReplicaSet(1), HpaSpec(target_qps_per_replica=1, target_p95_ms=100.0),
                       metric_fn=lambda: 0.0)

    def test_missing_sampler_rejected(self):
        with pytest.raises(ValueError, match="p95_ms"):
            Autoscaler(FakeReplicaSet(1), HpaSpec(target_qps_per_replica=1, target_p95_ms=100.0),
                       metric_fn={"qps": lambda: 0.0})

    def test_stabilization_applies_across_metrics(self):
        assert_same_decisions(
            [(0, {"qps": 35.0, "p95_ms": 100.0}), (5, {"qps": 0.0}), (31, {"qps": 0.0})], [4, 4, 2],
            target_qps_per_replica=10.0, target_p95_ms=200.0, scale_down_stabilization_s=30.0)

    def test_latency_ratio_scales_directly(self):
        assert_same_decisions([(0, {"p95_ms": 150.0}), (1, {"p95_ms": 0.0}), (1, {"p95_ms": 10.0})], [6, 6, 2],
                              current=2, target_p95_ms=50.0, max_replicas=8, scale_down_stabilization_s=0)


class TestLatencySamplers:
    def test_histogram_quantile_sampler_equals_jax(self):
        import prometheus_client as prom

        from seldon_core_tpu.utils.metrics import HistogramQuantileSampler as JaxSampler
        from seldon_core_tpu_torch.utils import metrics

        reg = metrics.Registry()
        buckets = (0.01, 0.05, 0.1, 0.5, 1.0)
        fam = reg.family("histogram", "lat_seconds", (), "d", buckets=buckets)
        jax_hist = prom.Histogram("lat_seconds", "d", registry=prom.CollectorRegistry(), buckets=buckets)
        mine, theirs = metrics.HistogramQuantileSampler(fam.labels(), 0.95), JaxSampler(jax_hist, 0.95)
        assert mine() == theirs() == 0.0
        rng = np.random.default_rng(3)
        for _ in range(5):
            for v in rng.gamma(2.0, 0.05, size=int(rng.integers(5, 80))):
                fam.labels().observe(float(v))
                jax_hist.observe(float(v))
            assert mine() == pytest.approx(theirs(), rel=1e-12)
        assert mine() == theirs() == 0.0  # no traffic since the last sample

    def test_api_latency_sampler_reads_observer_histogram(self):
        from seldon_core_tpu_torch.utils.metrics import PrometheusObserver, Registry, api_latency_sampler

        obs = PrometheusObserver(deployment_name="d", predictor_name="p", registry=Registry())
        sampler = api_latency_sampler(obs)
        sampler()
        for _ in range(100):
            obs("predict_done", "m", 0.2)
        assert 0.05 < sampler() <= 0.5

    def test_worker_health_gauges(self):
        from seldon_core_tpu_torch.utils import metrics

        reg = metrics.Registry()
        metrics.record_worker_health("w-1", 3, True, registry=reg)
        text = metrics.generate_latest(reg).decode()
        assert 'seldon_tpu_worker_restarts{worker="w-1"} 3.0' in text
        assert 'seldon_tpu_worker_exhausted{worker="w-1"} 1.0' in text


def _gone(pids, deadline_s=10.0):
    for pid in pids:
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            try:
                os.kill(pid, 0)
            except OSError:
                break
            time.sleep(0.1)
        else:
            return False
    return True


class TestReplicaSetE2E:
    def test_load_ramp_scales_up_then_drains(self):
        from seldon_core_tpu_torch.controlplane.supervisor import ProcessSpec

        endpoints = []
        rs = ReplicaSet(
            ProcessSpec(name="stub", component="seldon_core_tpu_torch.engine.units.StubModel",
                        http_port=0, grpc_port=0, api="REST"),
            wait_ready_s=90.0,
            on_change=lambda specs: endpoints.append([s.http_port for s in specs]),
        )
        load = {"v": 0.0}
        hpa = HpaSpec(min_replicas=1, max_replicas=2, target_qps_per_replica=10.0,
                      scale_down_stabilization_s=0.0, poll_interval_s=0.1)
        asc = Autoscaler(rs, hpa, metric_fn=lambda: load["v"])
        pids = []
        try:
            assert rs.scale(1) == 1
            load["v"] = 25.0
            assert asc.evaluate_once() == 2
            pids = [r.proc.pid for r in rs.processes.values()]
            assert len(pids) == 2 and all("seldon_core_tpu_torch.runtime.microservice" in r.proc.args
                                          for r in rs.processes.values())
            for spec in rs.specs:
                with urllib.request.urlopen(f"http://127.0.0.1:{spec.http_port}/health/ping", timeout=5) as resp:
                    assert resp.status == 200
            load["v"] = 0.0
            assert asc.evaluate_once() == 1
            assert rs.replica_count == 1 and len(endpoints[-1]) == 1
        finally:
            asc.stop()
            rs.stop_all()
        assert _gone(pids)


class TestDeployerHpaIntegration:
    def test_hpa_predictor_serves_via_replicas_and_cleans_up(self):
        from seldon_core_tpu_torch.controlplane import Deployer, TpuDeployment
        from seldon_core_tpu_torch.engine import server
        from seldon_core_tpu_torch.runtime.message import InternalMessage

        spec = TpuDeployment.from_dict({
            "name": "hpa-e2e",
            "predictors": [{
                "name": "main", "traffic": 100,
                "hpa": {"min_replicas": 1, "max_replicas": 2, "target_qps_per_replica": 1e9,
                        "poll_interval_s": 30.0},
                "graph": {"name": "stub", "type": "MODEL", "implementation": "SIMPLE_MODEL"},
            }],
        })

        async def scenario():
            from aiohttp.test_utils import TestClient, TestServer

            deployer = Deployer(device_ids=[0])
            managed = await deployer.apply(spec, ready_timeout_s=90.0)
            try:
                gen = managed.current
                assert len(gen.replicasets) == 1 and len(gen.autoscalers) == 1
                pids = [r.proc.pid for r in gen.replicasets[0].processes.values()]
                out = await managed.gateway.predict(InternalMessage(payload=np.ones((1, 2))))
                assert out.status is None or out.status.get("status") != "FAILURE"
                assert out.payload is not None
                client = TestClient(TestServer(server.build_gateway_app(managed.gateway)))
                await client.start_server()
                try:
                    workers = await (await client.get("/debug/workers")).json()
                finally:
                    await client.close()
                assert list(workers["workers"]) == ["main-stub-1"]
                assert workers["workers"]["main-stub-1"]["state"] == "running" and workers["exhausted"] == []
            finally:
                await deployer.delete("hpa-e2e")
            return pids

        assert _gone(asyncio.run(scenario()))


class TestDeviceExclusivityGuard:
    """C27: several processes share one CUDA card, so the guard refuses
    hpa replicas only of a class that declares ``device_exclusive``."""

    def _spec(self, component, max_replicas):
        from seldon_core_tpu_torch.controlplane import TpuDeployment

        return TpuDeployment.from_dict({
            "name": "guard",
            "predictors": [{
                "name": "main", "traffic": 100,
                "hpa": {"min_replicas": 1, "max_replicas": max_replicas, "target_qps_per_replica": 1e9},
                "graph": {"name": "clf", "type": "MODEL", "implementation": component},
            }],
        })

    def test_generative_lm_with_two_replicas_is_refused(self):
        from seldon_core_tpu_torch.controlplane.deployer import build_generation
        from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError

        with pytest.raises(DeploymentSpecError, match="device-exclusive.*C27"):
            build_generation(self._spec("GENERATIVE_LM", 2), device_ids=[0])

    def test_cuda_server_and_pinned_generative_lm_are_admitted(self):
        from seldon_core_tpu_torch.controlplane.deployer import _reject_device_exclusive_root

        for component, max_replicas in (("seldon_core_tpu_torch.models.cudaserver.CudaServer", 2),
                                        ("seldon_core_tpu_torch.models.paged.StreamingLM", 4),
                                        ("seldon_core_tpu_torch.models.generate.GenerativeLM", 1)):
            _reject_device_exclusive_root("main", component, HpaSpec(max_replicas=max_replicas,
                                                                     target_qps_per_replica=10.0))
        with pytest.raises(Exception, match="device-exclusive"):
            _reject_device_exclusive_root("main", "seldon_core_tpu_torch.models.generate.GenerativeLM",
                                          HpaSpec(max_replicas=2, target_qps_per_replica=10.0))

    def test_device_exclusive_flags(self):
        from seldon_core_tpu_torch.models.cudaserver import CudaServer
        from seldon_core_tpu_torch.models.disagg import DisaggregatedLM
        from seldon_core_tpu_torch.models.generate import GenerativeLM
        from seldon_core_tpu_torch.models.paged import StreamingLM

        assert GenerativeLM.device_exclusive
        assert not CudaServer.device_exclusive
        assert not StreamingLM.device_exclusive and not DisaggregatedLM.device_exclusive
