"""gRPC service descriptions for the seven node-role services.

The environment has no ``grpcio-tools`` code generator, so instead of
generated stub classes we describe each service as a method table and
build servers/clients with gRPC's generic-handler API.  The services and
method signatures mirror the reference contract
(reference: proto/prediction.proto:94-128).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from seldon_core_tpu_torch.proto import pb

PACKAGE = "seldon.protos"

# service name -> {method name -> (request class, response class)}
SERVICES: Dict[str, Dict[str, Tuple[type, type]]] = {
    "Generic": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Model": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Router": {
        "Route": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
    "Transformer": {
        "TransformInput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "OutputTransformer": {
        "TransformOutput": (pb.SeldonMessage, pb.SeldonMessage),
    },
    "Combiner": {
        "Aggregate": (pb.SeldonMessageList, pb.SeldonMessage),
    },
    "Seldon": {
        "Predict": (pb.SeldonMessage, pb.SeldonMessage),
        "SendFeedback": (pb.Feedback, pb.SeldonMessage),
    },
}


# stream-stream methods (transport-level chunking; additive to the
# reference contract): method -> (chunk class in, chunk class out)
STREAM_METHODS: Dict[str, Dict[str, Tuple[type, type]]] = {
    "Seldon": {
        "PredictStream": (pb.MessageChunk, pb.MessageChunk),
    },
}

# unary-stream methods (server streaming; additive): token streaming
# for the generation family — one prompt in, incremental token chunks
# out as the continuous-batching engine emits them
UNARY_STREAM_METHODS: Dict[str, Dict[str, Tuple[type, type]]] = {
    "Seldon": {
        "GenerateStream": (pb.SeldonMessage, pb.SeldonMessage),
    },
}

# default chunk payload size for the streaming lanes (1 MiB keeps each
# frame comfortably under any configured gRPC message cap)
STREAM_CHUNK_BYTES = 1 << 20

# total reassembled-message cap for a stream (env-overridable): the
# per-frame gRPC limit stops bounding memory once frames accumulate,
# so the stream lane enforces its own ceiling
import os as _os

STREAM_MAX_BYTES = int(_os.environ.get("SELDON_STREAM_MAX_BYTES", str(2 << 30)))


def chunk_message(msg, chunk_bytes: int = STREAM_CHUNK_BYTES):
    """Serialize a proto message into a MessageChunk iterator."""
    raw = msg.SerializeToString()
    if not raw:
        yield pb.MessageChunk(data=b"")
        return
    for off in range(0, len(raw), chunk_bytes):
        yield pb.MessageChunk(data=raw[off:off + chunk_bytes])


def assemble_chunks(chunks, cls):
    """Reassemble a MessageChunk iterable into a `cls` message."""
    return cls.FromString(b"".join(c.data for c in chunks))


def full_service_name(service: str) -> str:
    return f"{PACKAGE}.{service}"


def method_path(service: str, method: str) -> str:
    """The gRPC request path, e.g. ``/seldon.protos.Model/Predict``."""
    return f"/{PACKAGE}.{service}/{method}"


def generic_handler(service: str, dispatch: Dict[str, Callable]):
    """Build a grpc generic handler for `service`.

    `dispatch` maps method name -> callable(request, context) -> response.
    Methods absent from `dispatch` are omitted (gRPC returns UNIMPLEMENTED).
    """
    import grpc

    handlers = {}
    for method, (req_cls, resp_cls) in SERVICES[service].items():
        fn = dispatch.get(method)
        if fn is None:
            continue
        handlers[method] = grpc.unary_unary_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg, _c=resp_cls: msg.SerializeToString(),
        )
    for method, (req_cls, resp_cls) in STREAM_METHODS.get(service, {}).items():
        fn = dispatch.get(method)
        if fn is None:
            continue
        handlers[method] = grpc.stream_stream_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg, _c=resp_cls: msg.SerializeToString(),
        )
    for method, (req_cls, resp_cls) in UNARY_STREAM_METHODS.get(service, {}).items():
        fn = dispatch.get(method)
        if fn is None:
            continue
        handlers[method] = grpc.unary_stream_rpc_method_handler(
            fn,
            request_deserializer=req_cls.FromString,
            response_serializer=lambda msg, _c=resp_cls: msg.SerializeToString(),
        )
    return grpc.method_handlers_generic_handler(full_service_name(service), handlers)


def stream_callable(channel, service: str, method: str):
    """Client-side stream-stream callable for service/method."""
    _req_cls, resp_cls = STREAM_METHODS[service][method]
    return channel.stream_stream(
        method_path(service, method),
        request_serializer=lambda msg: msg.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )


def unary_stream_callable(channel, service: str, method: str):
    """Client-side unary-stream callable (server streaming)."""
    _req_cls, resp_cls = UNARY_STREAM_METHODS[service][method]
    return channel.unary_stream(
        method_path(service, method),
        request_serializer=lambda msg: msg.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )


def unary_callable(channel, service: str, method: str):
    """Build a client-side unary-unary callable for service/method."""
    req_cls, resp_cls = SERVICES[service][method]
    return channel.unary_unary(
        method_path(service, method),
        request_serializer=lambda msg: msg.SerializeToString(),
        response_deserializer=resp_cls.FromString,
    )
