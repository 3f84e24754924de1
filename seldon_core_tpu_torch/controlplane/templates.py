"""Deployment template pack — the helm-chart equivalent.

The reference ships 12 helm charts as its deployable graph templates
(reference: helm-charts/README.md; chart list `seldon-single-model`,
`seldon-abtest`, `seldon-mab`, `seldon-od-model`, `seldon-od-transformer`,
`seldon-openvino`, `seldon-core-analytics`, `seldon-core-kafka`,
`seldon-core-loadtesting`, `seldon-core-operator`, `seldon-core-controller`,
`seldon-core-crd`) — each a parameterized generator that `helm install
--set k=v` renders into manifests.  This module is the native twin:
every template is a typed-parameter builder rendering either a
deployment spec (validated through :class:`TpuDeployment`, so a rendered
template can never be invalid) or a tool config, driven by the
``seldon-tpu-torch-template`` CLI::

    seldon-tpu-torch-template list
    seldon-tpu-torch-template show mab
    seldon-tpu-torch-template render mab --set epsilon=0.1 --set branches=3
    seldon-tpu-torch-template render single-model -o dep.yaml && seldon-tpu-torch-deploy run dep.yaml

The port renders the JAX package's dicts with two differences: model
nodes name ``CUDA_SERVER`` (C26), and the control-plane config's shell
line names the port's deployer CLI.

Design notes (not a port): helm templates are text substitution over
YAML with unchecked values; these are Python builders over the spec
dataclasses, so parameter types are enforced at render time and the
output is re-validated before it is printed.  The three operator charts
(`seldon-core-operator`/`-controller`/`-crd`) collapse into one
``controlplane`` template here because this framework's CRD is the spec
schema itself (controlplane/spec.py) and its operator is the in-process
deployer/supervisor — there is no third artifact to install.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

from seldon_core_tpu_torch.controlplane.spec import TpuDeployment

__all__ = ["Template", "TemplateError", "TEMPLATES", "render", "main"]


class TemplateError(ValueError):
    pass


@dataclass
class Param:
    name: str
    default: Any
    kind: str = "str"  # str | int | float | bool | json
    help: str = ""

    def cast(self, raw: Any) -> Any:
        try:
            if self.kind == "str":
                return str(raw)
            if self.kind == "int":
                return int(raw)
            if self.kind == "float":
                return float(raw)
            if self.kind == "bool":
                if isinstance(raw, bool):
                    return raw
                return str(raw).lower() in ("1", "true", "yes")
            if self.kind == "json":
                return json.loads(raw) if isinstance(raw, str) else raw
        except (ValueError, json.JSONDecodeError) as e:
            raise TemplateError(f"parameter {self.name!r}: cannot parse {raw!r} as {self.kind}") from e
        raise TemplateError(f"parameter {self.name!r}: unknown kind {self.kind}")


@dataclass
class Template:
    name: str
    description: str
    reference_chart: str
    kind: str  # "deployment" -> validated TpuDeployment; "config" -> tool config
    params: List[Param]
    build: Callable[[Dict[str, Any]], Dict[str, Any]] = field(repr=False, default=None)  # type: ignore[assignment]

    def render(self, overrides: Dict[str, Any]) -> Dict[str, Any]:
        known = {p.name: p for p in self.params}
        unknown = sorted(set(overrides) - set(known))
        if unknown:
            raise TemplateError(
                f"template {self.name!r} has no parameter(s) {unknown}; "
                f"known: {sorted(known)}"
            )
        values = {p.name: p.default for p in self.params}
        for k, v in overrides.items():
            values[k] = known[k].cast(v)
        out = self.build(values)
        if self.kind == "deployment":
            # full control-plane validation, not just parsing — a
            # rendered template can never be invalid
            from seldon_core_tpu_torch.controlplane.defaulting import default_and_validate

            default_and_validate(TpuDeployment.from_dict(out))
        return out


# --------------------------------------------------------------------------
# helpers shared by the deployment builders

def _typed(params: Dict[str, Any]) -> List[Dict[str, str]]:
    """kwargs -> the wire's typed [{name,value,type}] list (runtime/params.py)."""
    out = []
    for name, value in params.items():
        if isinstance(value, bool):
            t, v = "BOOL", "true" if value else "false"
        elif isinstance(value, int):
            t, v = "INT", str(value)
        elif isinstance(value, float):
            t, v = "FLOAT", repr(value)
        elif isinstance(value, (list, dict)):
            t, v = "JSON", json.dumps(value)
        else:
            t, v = "STRING", str(value)
        out.append({"name": name, "value": v, "type": t})
    return out


def _cuda_model(name: str, *, model: str, num_classes: int, input_shape: List[int],
               seed: int = 0, extra: Dict[str, Any] | None = None) -> Dict[str, Any]:
    params: Dict[str, Any] = {
        "model": model,
        "num_classes": num_classes,
        "input_shape": input_shape,
        "dtype": "float32",
        "seed": seed,
    }
    params.update(extra or {})
    return {
        "name": name,
        "type": "MODEL",
        "implementation": "CUDA_SERVER",
        "parameters": _typed(params),
    }


# outlier detector family shared by od-model / od-transformer
# (reference: helm-charts/seldon-od-model/values.yaml model.type +
# per-type blocks; the vae/seq2seq/mahalanobis trio plus this
# framework's packed-array isolation forest)
_DETECTORS: Dict[str, Dict[str, Any]] = {
    # params match the constructor signatures in components/outliers.py
    "mahalanobis": {"implementation": "OUTLIER_MAHALANOBIS",
                    "params": {"threshold": 25.0, "min_samples": 10}},
    "vae": {"implementation": "OUTLIER_VAE",
            "params": {"threshold": 10.0, "latent_dim": 2}},
    "isolation_forest": {"implementation": "OUTLIER_ISOLATION_FOREST",
                         "params": {"n_trees": 64, "threshold": 0.6}},
    "seq2seq": {"implementation": "OUTLIER_SEQ2SEQ",
                "params": {"threshold": 0.003}},
}


def _detector_unit(name: str, unit_type: str, detector: str, threshold: float | None,
                   n_features: int) -> Dict[str, Any]:
    if detector not in _DETECTORS:
        raise TemplateError(
            f"unknown detector {detector!r}; choose from {sorted(_DETECTORS)}")
    cfg = _DETECTORS[detector]
    params = dict(cfg["params"])
    params["n_features"] = n_features
    if threshold is not None:
        params["threshold"] = threshold
    return {
        "name": name,
        "type": unit_type,
        "implementation": cfg["implementation"],
        "parameters": _typed(params),
    }


# --------------------------------------------------------------------------
# deployment templates

def _build_single_model(v: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "name": v["name"],
        "predictors": [{
            "name": "main",
            "traffic": 100,
            "replicas": v["replicas"],
            "graph": _cuda_model(
                v["model_name"], model=v["model"], num_classes=v["num_classes"],
                input_shape=v["input_shape"],
                extra={"softmax_outputs": True} if v["softmax"] else None),
        }],
    }


def _build_abtest(v: Dict[str, Any]) -> Dict[str, Any]:
    if not 0.0 <= v["traffic_modela"] <= 1.0:
        raise TemplateError(
            "traffic_modela is a fraction in [0, 1] "
            f"(the chart's percentage / 100), got {v['traffic_modela']}")
    pct_a = round(100.0 * v["traffic_modela"], 4)
    return {
        "name": v["name"],
        "predictors": [
            {
                "name": "modela", "traffic": pct_a,
                "graph": _cuda_model("classifier-1", model=v["model"],
                                    num_classes=v["num_classes"],
                                    input_shape=v["input_shape"], seed=1),
            },
            {
                "name": "modelb", "traffic": round(100.0 - pct_a, 4),
                "graph": _cuda_model("classifier-2", model=v["model"],
                                    num_classes=v["num_classes"],
                                    input_shape=v["input_shape"], seed=2),
            },
        ],
    }


def _build_mab(v: Dict[str, Any]) -> Dict[str, Any]:
    router = v["router"]
    if router == "epsilon_greedy":
        unit = {"name": v["router_name"], "type": "ROUTER",
                "implementation": "EPSILON_GREEDY",
                "parameters": _typed({"n_branches": v["branches"],
                                      "epsilon": v["epsilon"]})}
    elif router == "thompson":
        unit = {"name": v["router_name"], "type": "ROUTER",
                "implementation": "THOMPSON_SAMPLING",
                "parameters": _typed({"n_branches": v["branches"]})}
    else:
        raise TemplateError(f"unknown router {router!r}; choose epsilon_greedy or thompson")
    unit["children"] = [
        _cuda_model(f"model-{chr(ord('a') + i)}", model=v["model"],
                   num_classes=v["num_classes"], input_shape=v["input_shape"],
                   seed=i + 1)
        for i in range(v["branches"])
    ]
    return {"name": v["name"],
            "predictors": [{"name": "main", "traffic": 100, "graph": unit}]}


def _build_od_model(v: Dict[str, Any]) -> Dict[str, Any]:
    return {
        "name": v["name"],
        "predictors": [{
            "name": "main", "traffic": 100,
            "graph": _detector_unit("outlier-detector", "MODEL", v["detector"],
                                    v["threshold"], v["n_features"]),
        }],
    }


def _build_od_transformer(v: Dict[str, Any]) -> Dict[str, Any]:
    guard = _detector_unit("outlier-guard", "TRANSFORMER", v["detector"],
                           v["threshold"], v["n_features"])
    guard["children"] = [_cuda_model("classifier", model=v["model"],
                                    num_classes=v["num_classes"],
                                    input_shape=v["input_shape"])]
    return {"name": v["name"],
            "predictors": [{"name": "main", "traffic": 100, "graph": guard}]}


def _build_proxy_model(v: Dict[str, Any]) -> Dict[str, Any]:
    dialect = v["dialect"]
    if dialect == "tensorflow":
        impl, params = "TENSORFLOW_SERVER", {
            "grpc_endpoint": f"{v['host']}:{v['port']}",
            "model_name": v["model_name"]}
    elif dialect == "sagemaker":
        impl, params = "SAGEMAKER_PROXY", {
            "url": f"http://{v['host']}:{v['port']}/invocations"}
    elif dialect == "rest":
        impl, params = "REST_PROXY", {
            "url": f"http://{v['host']}:{v['port']}{v['path']}"}
    else:
        raise TemplateError(
            f"unknown dialect {dialect!r}; choose tensorflow, sagemaker or rest")
    return {
        "name": v["name"],
        "predictors": [{
            "name": "main", "traffic": 100,
            "graph": {"name": v["model_name"], "type": "MODEL",
                      "implementation": impl, "parameters": _typed(params)},
        }],
    }


def _build_kafka_logging(v: Dict[str, Any]) -> Dict[str, Any]:
    spec = _build_single_model({**v, "softmax": False})
    spec["annotations"] = {
        "seldon.io/request-log-kafka": f"{v['brokers']}/{v['topic']}",
    }
    return spec


def _build_generation(v: Dict[str, Any]) -> Dict[str, Any]:
    # param names match StreamingLM.__init__ (models/paged.py)
    params: Dict[str, Any] = {
        "d_model": v["d_model"], "num_layers": v["num_layers"],
        "num_heads": v["num_heads"], "vocab_size": v["vocab_size"],
        "max_len": v["max_len"],
    }
    if v["speculative"]:
        params["speculative"] = {"draft": "ngram", "draft_k": v["draft_k"]}
    return {
        "name": v["name"],
        "predictors": [{
            "name": "main", "traffic": 100,
            "graph": {"name": "lm", "type": "MODEL",
                      "implementation": "STREAMING_LM",
                      "parameters": _typed(params)},
        }],
    }


# --------------------------------------------------------------------------
# config templates (the non-deployment charts)

def _build_analytics(v: Dict[str, Any]) -> Dict[str, Any]:
    # reference: helm-charts/seldon-core-analytics installs
    # prometheus + grafana + alertmanager with prebuilt dashboards;
    # here the stack is the monitoring/ tree and this template renders
    # the scrape config wiring for a gateway set
    targets = v["targets"]
    if isinstance(targets, str):
        targets = [targets]
    return {
        "kind": "analytics",
        "prometheus": {
            "global": {"scrape_interval": f"{v['scrape_interval_s']}s"},
            "scrape_configs": [{
                "job_name": "seldon-tpu-gateways",
                "metrics_path": "/metrics",
                "static_configs": [{"targets": targets}],
            }],
        },
        "grafana_dashboards": [
            "monitoring/grafana/predictions-dashboard.json",
            "monitoring/grafana/generation-dashboard.json",
            "monitoring/grafana/outlier-detection-dashboard.json",
        ],
        "alert_rules": "monitoring/alert-rules.yml",
    }


def _build_loadtest(v: Dict[str, Any]) -> Dict[str, Any]:
    # reference: helm-charts/seldon-core-loadtesting runs the locust
    # master/worker harness (util/loadtester/); ours renders the
    # seldon-tpu-load invocation for the same experiment
    argv = [
        "seldon-tpu-load", v["host"], str(v["port"]),
        "--path", v["path"], "--shape", v["shape"],
        "--duration", str(v["duration_s"]),
        "--concurrency", str(v["concurrency"]),
    ]
    if v["native"]:
        argv += ["--native", "--connections", str(v["connections"]),
                 "--depth", str(v["depth"])]
    return {"kind": "loadtest", "argv": argv,
            "equivalent_shell": " ".join(argv)}


def _build_controlplane(v: Dict[str, Any]) -> Dict[str, Any]:
    # the operator/controller/crd trio collapsed: spec schema is the
    # CRD, deployer+supervisor are the operator (module docstring)
    return {
        "kind": "controlplane",
        "gateway": {"host": v["host"], "http_port": v["http_port"],
                    "grpc_port": v["grpc_port"]},
        "native_ingress": {"enabled": v["native_ingress"],
                           "port": v["native_port"]},
        "autoscaler": {"enabled": v["autoscaler"],
                       "tick_s": v["autoscaler_tick_s"]},
        "supervisor": {"restart_backoff_s": v["restart_backoff_s"],
                       "max_restarts": v["max_restarts"]},
        "equivalent_shell": (
            f"seldon-tpu-torch-deploy run <spec.yaml> --http-port {v['http_port']} "
            f"--grpc-port {v['grpc_port']}"
            + (" --native-frontend" if v["native_ingress"] else "")),
    }


# --------------------------------------------------------------------------

_SHAPE = [4]

TEMPLATES: Dict[str, Template] = {
    t.name: t for t in [
        Template(
            "single-model", "One model behind the gateway — the canonical first deployment",
            "seldon-single-model", "deployment",
            [Param("name", "my-model"), Param("model_name", "classifier"),
             Param("model", "mlp"), Param("num_classes", 3, "int"),
             Param("input_shape", _SHAPE, "json"), Param("replicas", 1, "int"),
             Param("softmax", False, "bool")],
            _build_single_model),
        Template(
            "abtest", "Weighted A/B split over two models",
            "seldon-abtest", "deployment",
            [Param("name", "abtest"), Param("model", "mlp"),
             Param("num_classes", 3, "int"), Param("input_shape", _SHAPE, "json"),
             Param("traffic_modela", 0.5, "float",
                   "fraction of traffic to model A (chart: traffic_modela_percentage)")],
            _build_abtest),
        Template(
            "mab", "Multi-armed-bandit router over N models, trained by feedback",
            "seldon-mab", "deployment",
            [Param("name", "mab-demo"), Param("router", "epsilon_greedy", "str",
                   "epsilon_greedy | thompson"),
             Param("router_name", "eg-router"), Param("branches", 2, "int"),
             Param("epsilon", 0.2, "float"), Param("model", "mlp"),
             Param("num_classes", 3, "int"), Param("input_shape", _SHAPE, "json")],
            _build_mab),
        Template(
            "od-model", "Standalone outlier detector served as a MODEL",
            "seldon-od-model", "deployment",
            [Param("name", "seldon-od-model"),
             Param("detector", "mahalanobis", "str",
                   " | ".join(sorted(_DETECTORS))),
             Param("threshold", None, "float", "detector threshold (default: per-type)"),
             Param("n_features", 4, "int")],
            _build_od_model),
        Template(
            "od-transformer", "Outlier detector guarding a model as input TRANSFORMER",
            "seldon-od-transformer", "deployment",
            [Param("name", "seldon-od-transformer"),
             Param("detector", "mahalanobis", "str", " | ".join(sorted(_DETECTORS))),
             Param("threshold", None, "float"), Param("n_features", 4, "int"),
             Param("model", "mlp"), Param("num_classes", 3, "int"),
             Param("input_shape", _SHAPE, "json")],
            _build_od_transformer),
        Template(
            "proxy-model", "Proxy to an external inference server",
            "seldon-openvino", "deployment",
            [Param("name", "proxied-model"), Param("model_name", "model"),
             Param("dialect", "tensorflow", "str", "tensorflow | sagemaker | rest"),
             Param("host", "127.0.0.1"), Param("port", 8500, "int"),
             Param("path", "/predict")],
            _build_proxy_model),
        Template(
            "kafka-logging", "Model with request/response pairs streamed to Kafka",
            "seldon-core-kafka", "deployment",
            [Param("name", "kafka-logged"), Param("model_name", "classifier"),
             Param("model", "mlp"), Param("num_classes", 3, "int"),
             Param("input_shape", _SHAPE, "json"), Param("replicas", 1, "int"),
             Param("brokers", "127.0.0.1:9092"), Param("topic", "seldon-pairs")],
            _build_kafka_logging),
        Template(
            "generation", "Continuous-batching LM serving (no reference counterpart)",
            "—", "deployment",
            [Param("name", "lm-serving"), Param("d_model", 512, "int"),
             Param("num_layers", 8, "int"), Param("num_heads", 8, "int"),
             Param("vocab_size", 32000, "int"), Param("max_len", 2048, "int"),
             Param("speculative", False, "bool"), Param("draft_k", 4, "int")],
            _build_generation),
        Template(
            "analytics", "Prometheus scrape config + Grafana dashboard bundle",
            "seldon-core-analytics", "config",
            [Param("targets", ["127.0.0.1:8000"], "json",
                   "gateway metrics endpoints to scrape"),
             Param("scrape_interval_s", 5, "int")],
            _build_analytics),
        Template(
            "loadtest", "Render the load-test invocation for a target",
            "seldon-core-loadtesting", "config",
            [Param("host", "127.0.0.1"), Param("port", 8000, "int"),
             Param("path", "/api/v0.1/predictions"), Param("shape", "1,4"),
             Param("duration_s", 10.0, "float"), Param("concurrency", 16, "int"),
             Param("native", False, "bool"), Param("connections", 8, "int"),
             Param("depth", 16, "int")],
            _build_loadtest),
        Template(
            "controlplane", "Control-plane process config (operator+controller+crd)",
            "seldon-core-operator / seldon-core-controller / seldon-core-crd", "config",
            [Param("host", "0.0.0.0"), Param("http_port", 8000, "int"),
             Param("grpc_port", 8001, "int"),
             Param("native_ingress", False, "bool"), Param("native_port", 8080, "int"),
             Param("autoscaler", False, "bool"), Param("autoscaler_tick_s", 5.0, "float"),
             Param("restart_backoff_s", 1.0, "float"), Param("max_restarts", 5, "int")],
            _build_controlplane),
    ]
}


def render(name: str, overrides: Dict[str, Any] | None = None) -> Dict[str, Any]:
    if name not in TEMPLATES:
        raise TemplateError(f"unknown template {name!r}; try: {sorted(TEMPLATES)}")
    return TEMPLATES[name].render(overrides or {})


# --------------------------------------------------------------------------
# CLI

def main(argv: List[str] | None = None) -> int:
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="seldon-tpu-torch-template",
        description="Render parameterized deployment templates (the helm-chart equivalent)")
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list templates")
    show = sub.add_parser("show", help="show a template's parameters")
    show.add_argument("template")
    rend = sub.add_parser("render", help="render a template to YAML/JSON")
    rend.add_argument("template")
    rend.add_argument("--set", dest="sets", action="append", default=[],
                      metavar="KEY=VALUE", help="override a parameter (repeatable)")
    rend.add_argument("--json", action="store_true", help="emit JSON instead of YAML")
    rend.add_argument("-o", "--output", default="", help="write to file instead of stdout")
    args = parser.parse_args(argv)

    if args.cmd == "list":
        width = max(len(n) for n in TEMPLATES)
        for t in TEMPLATES.values():
            print(f"{t.name:<{width}}  [{t.kind:>10}]  {t.description}  "
                  f"(chart: {t.reference_chart})")
        return 0

    if args.cmd == "show":
        try:
            t = TEMPLATES[args.template]
        except KeyError:
            print(f"unknown template {args.template!r}", file=sys.stderr)
            return 2
        print(f"{t.name} — {t.description}")
        print(f"reference chart: {t.reference_chart}   kind: {t.kind}")
        for p in t.params:
            extra = f"  ({p.help})" if p.help else ""
            print(f"  --set {p.name}=<{p.kind}>   default: {p.default!r}{extra}")
        return 0

    overrides: Dict[str, Any] = {}
    for s in args.sets:
        if "=" not in s:
            print(f"--set needs KEY=VALUE, got {s!r}", file=sys.stderr)
            return 2
        k, _, v = s.partition("=")
        overrides[k] = v
    from seldon_core_tpu_torch.controlplane.spec import DeploymentSpecError

    try:
        out = render(args.template, overrides)
    except (TemplateError, DeploymentSpecError) as e:
        print(str(e), file=sys.stderr)
        return 2
    if args.json:
        text = json.dumps(out, indent=2) + "\n"
    else:
        import yaml
        text = yaml.safe_dump(out, sort_keys=False)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print(f"wrote {args.output}", file=sys.stderr)
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
