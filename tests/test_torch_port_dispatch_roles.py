"""The port's node-role dispatch against the JAX package's.

Each role (predict, transform_input, transform_output, route, aggregate,
send_feedback) runs a toy component class defined here (plain numpy,
duck-typed, so one class serves both packages) through
``seldon_core_tpu.runtime.dispatch`` and through the port's.  Inputs are
one serialized ``SeldonMessage`` parsed by each package; the resulting
protos are compared field for field (deterministic serialization) with
the puid cleared.  The refusals give the same exception type, status
code, reason and text.
"""

import numpy as np
import pytest

from seldon_core_tpu.proto import pb as jax_pb
from seldon_core_tpu.runtime import component as jax_comp
from seldon_core_tpu.runtime import dispatch as jax_dispatch
from seldon_core_tpu.runtime.message import InternalFeedback as JaxFeedback
from seldon_core_tpu.runtime.message import InternalMessage as JaxMessage
from seldon_core_tpu_torch.proto import pb
from seldon_core_tpu_torch.runtime import component as comp
from seldon_core_tpu_torch.runtime import dispatch
from seldon_core_tpu_torch.runtime.message import InternalFeedback, InternalMessage

PACKAGES = {
    "jax": (jax_dispatch, JaxMessage, JaxFeedback, jax_pb, jax_comp),
    "torch_port": (dispatch, InternalMessage, InternalFeedback, pb, comp),
}


class Scaler:
    """Every array role multiplies by a constant; tags, metrics and
    class names ride along."""

    def __init__(self, k=3.0):
        self.k = k
        self.feedback = []

    def predict(self, X, names, meta=None):
        return np.asarray(X) * self.k

    def transform_input(self, X, names, meta=None):
        return np.asarray(X) + self.k

    def transform_output(self, X, names, meta=None):
        return -np.asarray(X)

    def route(self, features, names):
        return int(np.asarray(features).ravel()[0] > 0)

    def aggregate(self, features_list, names_list):
        return np.mean([np.asarray(f) for f in features_list], axis=0)

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.feedback.append((float(reward), routing, None if truth is None else np.asarray(truth).tolist()))
        return np.array([[reward]])

    def tags(self):
        return {"scaled_by": self.k}

    def metrics(self):
        return [{"key": "scaler_calls", "type": "COUNTER", "value": 1.0}]

    def class_names(self):
        return ["a", "b", "c"]


class BadRouter:
    def route(self, features, names):
        return "left"


class PredictOnly:
    """A component with no role method at all."""


def request_bytes(kind: str, seed: int = 0) -> bytes:
    x = np.random.default_rng(seed).standard_normal((2, 3))
    msg = pb.SeldonMessage()
    msg.meta.puid = "request-puid"
    msg.meta.tags["client"].string_value = "tests"
    msg.data.names.extend(["f0", "f1", "f2"])
    if kind == "tensor":
        msg.data.tensor.shape.extend(x.shape)
        msg.data.tensor.values.extend(x.ravel().tolist())
    elif kind == "ndarray":
        for row in x:
            msg.data.ndarray.values.add().list_value.extend(row.tolist())
    else:
        msg.data.rawTensor.shape.extend(x.shape)
        msg.data.rawTensor.dtype = "float32"
        msg.data.rawTensor.data = x.astype(np.float32).tobytes()
    return msg.SerializeToString()


def parse(pkg: str, raw: bytes):
    _, Message, _, proto, _ = PACKAGES[pkg]
    return Message.from_proto(proto.SeldonMessage.FromString(raw))


def wire(out) -> bytes:
    """A result as deterministic proto bytes, puid cleared."""
    proto = out.to_proto()
    proto.meta.puid = ""
    return proto.SerializeToString(deterministic=True)


def run_role(pkg: str, role: str, kind: str, component) -> bytes:
    d, Message, Feedback, proto, _ = PACKAGES[pkg]
    raw = request_bytes(kind)
    if role == "aggregate":
        return wire(d.aggregate(component, [parse(pkg, raw), parse(pkg, request_bytes(kind, seed=1))]))
    if role == "send_feedback":
        fb = proto.Feedback(reward=0.25)
        fb.request.ParseFromString(raw)
        fb.response.ParseFromString(raw)
        fb.response.meta.routing["router-1"] = 1
        fb.truth.ParseFromString(request_bytes(kind, seed=2))
        return wire(d.send_feedback(component, Feedback.from_proto(fb), "router-1"))
    return wire(getattr(d, role)(component, parse(pkg, raw)))


ROLES = ["predict", "transform_input", "transform_output", "route", "aggregate", "send_feedback"]


@pytest.mark.parametrize("kind", ["tensor", "ndarray", "rawTensor"])
@pytest.mark.parametrize("role", ROLES)
def test_role_protos_equal_field_for_field(role, kind):
    got = {pkg: run_role(pkg, role, kind, Scaler()) for pkg in PACKAGES}
    assert got["torch_port"] == got["jax"]
    # the proto says something: a payload and this component's tags
    out = pb.SeldonMessage.FromString(got["torch_port"])
    assert out.WhichOneof("data_oneof") == "data"
    assert out.meta.tags["scaled_by"].number_value == 3.0


def test_feedback_routing_taken_from_the_response_for_this_unit():
    seen = {}
    for pkg in PACKAGES:
        model = Scaler()
        run_role(pkg, "send_feedback", "tensor", model)
        seen[pkg] = model.feedback
    assert seen["torch_port"] == seen["jax"]
    reward, routing, truth = seen["torch_port"][0]
    assert reward == 0.25 and routing == 1 and np.asarray(truth).shape == (2, 3)


def test_feedback_without_a_request_answers_an_empty_array():
    outs = {}
    for pkg, (d, _, Feedback, proto, _) in PACKAGES.items():
        outs[pkg] = wire(d.send_feedback(PredictOnly(), Feedback.from_proto(proto.Feedback(reward=1.0)), "u"))
    assert outs["torch_port"] == outs["jax"]


def test_puid_is_minted_when_absent():
    for pkg, (d, Message, _, _, _) in PACKAGES.items():
        msg = Message(payload=np.ones((1, 2)), kind="tensor")
        out = d.transform_input(Scaler(), msg)
        assert msg.meta.puid and out.meta.puid == msg.meta.puid, pkg


def refusal(pkg: str, fn):
    try:
        fn(*PACKAGES[pkg])
    except Exception as e:  # noqa: BLE001 — the refusal is what is compared
        return type(e).__name__, getattr(e, "status_code", None), getattr(e, "reason", None), str(e)
    raise AssertionError(f"{pkg}: no refusal")


REFUSALS = {
    "empty_aggregate": lambda d, M, F, p, c: d.aggregate(Scaler(), []),
    "bad_routing": lambda d, M, F, p, c: d.route(BadRouter(), M(payload=np.ones((1, 1)), kind="tensor")),
    "transform_input_not_implemented": lambda d, M, F, p, c: d.transform_input(
        type("Model", (c.TPUComponent,), {})(), M(payload=np.ones((1, 1)), kind="tensor")),
    "route_not_implemented": lambda d, M, F, p, c: d.route(
        type("Model", (c.TPUComponent,), {})(), M(payload=np.ones((1, 1)), kind="tensor")),
    "aggregate_not_implemented": lambda d, M, F, p, c: d.aggregate(
        type("Model", (c.TPUComponent,), {})(), [M(payload=np.ones((1, 1)), kind="tensor")]),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_match(case):
    got = {pkg: refusal(pkg, REFUSALS[case]) for pkg in PACKAGES}
    assert got["torch_port"] == got["jax"]
    expected = {"empty_aggregate": (400, "EMPTY_AGGREGATE"), "bad_routing": (500, "INVALID_ROUTING")}
    if case in expected:
        assert got["torch_port"][1:3] == expected[case]
    else:
        assert got["torch_port"][0] == "NotImplementedByUser" and got["torch_port"][1] == 400


def test_raw_overrides_take_precedence():
    class Raw:
        def route_raw(self, request):
            out = type(request)()
            out.data.ndarray.values.add().list_value.values.add().number_value = 0
            return out

        def route(self, features, names):  # never reached
            raise AssertionError("route_raw must win")

    outs = {pkg: wire(d.route(Raw(), parse(pkg, request_bytes("tensor"))))
            for pkg, (d, *_rest) in PACKAGES.items()}
    assert outs["torch_port"] == outs["jax"]


def test_feature_names_and_class_names_hooks():
    class Named(comp.TPUComponent):
        def class_names(self):
            return ("x", "y")

    assert comp.get_class_names(Named()) == ["x", "y"]
    assert comp.get_class_names(comp.TPUComponent()) == []
    assert comp.get_class_names(Scaler()) == ["a", "b", "c"]
    assert not hasattr(comp, "get_feature_names")  # its first caller is not ported
    assert comp.TPUComponent().custom_routes() == {}


class Routed(Scaler):
    """Scaler plus custom REST routes, one sync and one async."""

    def custom_routes(self):
        from aiohttp import web

        async def ping(request):
            return web.json_response({"async": True, "path": request.path})

        return {"/stats": lambda request: {"k": self.k}, "/async-stats": ping}


def _rest_bodies():
    from google.protobuf import json_format

    msg = json_format.MessageToDict(pb.SeldonMessage.FromString(request_bytes("tensor")))
    other = json_format.MessageToDict(pb.SeldonMessage.FromString(request_bytes("tensor", 1)))
    feedback = {"request": msg, "response": {"meta": {"routing": {"unit-1": 1}}}, "reward": 0.75, "truth": other}
    return [("/predict", msg), ("/api/v0.1/predictions", msg), ("/transform-input", msg),
            ("/transform-output", msg), ("/route", msg), ("/aggregate", {"seldonMessages": [msg, other]}),
            ("/send-feedback", feedback), ("/aggregate", {"seldonMessages": []}),
            ("/predict", {"data": {"ndarray": "oops"}})]


def _scrub(body):
    if isinstance(body, dict) and "meta" in body:
        body["meta"].pop("puid", None)
    return body


def test_rest_role_routes_match_jax():
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from seldon_core_tpu.runtime import rest as jax_rest
    from seldon_core_tpu_torch.runtime import rest

    async def drive(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for path, body in _rest_bodies():
                resp = await client.post(path, json=body)
                out.append((path, resp.status, _scrub(await resp.json())))
            for path in ("/stats", "/async-stats"):
                resp = await client.get(path)
                out.append((path, resp.status, await resp.json()))
            resp = await client.get("/seldon.json")
            doc = await resp.json()
            resp = await client.get("/metrics")
            metrics = await resp.text()
        return out, doc, metrics

    jax_out, jax_doc, _ = asyncio.run(drive(jax_rest.build_app(Routed(), unit_id="unit-1")))
    port_out, port_doc, port_metrics = asyncio.run(drive(rest.build_app(Routed(), unit_id="unit-1")))
    assert [(p, s) for p, s, _ in port_out] == [(p, s) for p, s, _ in jax_out]
    for (path, status, got), (_, _, want) in zip(port_out, jax_out):
        if status == 200:
            assert got == want, path
        else:
            assert got["status"]["reason"] == want["status"]["reason"], path
    assert port_out[7][1] == 400 and port_out[7][2]["status"]["reason"] == "EMPTY_AGGREGATE"
    assert port_out[-2] == ("/stats", 200, {"k": 3.0})
    assert port_out[-1] == ("/async-stats", 200, {"async": True, "path": "/async-stats"})
    assert port_doc["info"].pop("version") and jax_doc["info"].pop("version")
    assert port_doc == jax_doc
    assert "scaler_calls 1.0" in port_metrics
