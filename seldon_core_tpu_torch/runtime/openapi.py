"""OpenAPI document generation for the REST surfaces.

The reference ships hand-maintained OAS3 JSON for the engine and
wrapper APIs, served by the wrapper at ``/seldon.json``
(reference: openapi/engine.oas3.json, openapi/wrapper.oas3.json,
python/seldon_core/wrapper.py:36-38).  Here the documents are generated
from one schema source so they can't drift from the code.  The
documents are the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict

from seldon_core_tpu_torch import __version__

_SELDON_MESSAGE_SCHEMA: Dict[str, Any] = {
    "type": "object",
    "properties": {
        "status": {"$ref": "#/components/schemas/Status"},
        "meta": {"$ref": "#/components/schemas/Meta"},
        "data": {"$ref": "#/components/schemas/DefaultData"},
        "binData": {"type": "string", "format": "byte"},
        "strData": {"type": "string"},
        "jsonData": {},
    },
}

_SCHEMAS: Dict[str, Any] = {
    "SeldonMessage": _SELDON_MESSAGE_SCHEMA,
    "SeldonMessageList": {
        "type": "object",
        "properties": {
            "seldonMessages": {
                "type": "array",
                "items": {"$ref": "#/components/schemas/SeldonMessage"},
            }
        },
    },
    "DefaultData": {
        "type": "object",
        "properties": {
            "names": {"type": "array", "items": {"type": "string"}},
            "tensor": {"$ref": "#/components/schemas/Tensor"},
            "ndarray": {"type": "array", "items": {}},
            "rawTensor": {"$ref": "#/components/schemas/RawTensor"},
        },
    },
    "Tensor": {
        "type": "object",
        "properties": {
            "shape": {"type": "array", "items": {"type": "integer"}},
            "values": {"type": "array", "items": {"type": "number"}},
        },
    },
    "RawTensor": {
        "type": "object",
        "description": "zero-copy typed tensor: base64 little-endian bytes",
        "properties": {
            "shape": {"type": "array", "items": {"type": "integer"}},
            "dtype": {"type": "string", "example": "float32"},
            "data": {"type": "string", "format": "byte"},
        },
    },
    "Meta": {
        "type": "object",
        "properties": {
            "puid": {"type": "string"},
            "tags": {"type": "object"},
            "routing": {"type": "object", "additionalProperties": {"type": "integer"}},
            "requestPath": {"type": "object", "additionalProperties": {"type": "string"}},
            "metrics": {"type": "array", "items": {"$ref": "#/components/schemas/Metric"}},
        },
    },
    "Metric": {
        "type": "object",
        "properties": {
            "key": {"type": "string"},
            "type": {"type": "string", "enum": ["COUNTER", "GAUGE", "TIMER"]},
            "value": {"type": "number"},
            "tags": {"type": "object", "additionalProperties": {"type": "string"}},
        },
    },
    "Status": {
        "type": "object",
        "properties": {
            "code": {"type": "integer"},
            "info": {"type": "string"},
            "reason": {"type": "string"},
            "status": {"type": "string", "enum": ["SUCCESS", "FAILURE"]},
        },
    },
    "Feedback": {
        "type": "object",
        "properties": {
            "request": {"$ref": "#/components/schemas/SeldonMessage"},
            "response": {"$ref": "#/components/schemas/SeldonMessage"},
            "reward": {"type": "number"},
            "truth": {"$ref": "#/components/schemas/SeldonMessage"},
        },
    },
}


def _message_op(summary: str, request_schema: str = "SeldonMessage") -> Dict[str, Any]:
    return {
        "post": {
            "summary": summary,
            "requestBody": {
                "content": {
                    "application/json": {
                        "schema": {"$ref": f"#/components/schemas/{request_schema}"}
                    }
                },
                "required": True,
            },
            "responses": {
                "200": {
                    "description": "response message",
                    "content": {
                        "application/json": {
                            "schema": {"$ref": "#/components/schemas/SeldonMessage"}
                        }
                    },
                }
            },
        }
    }


def wrapper_openapi() -> Dict[str, Any]:
    """The node-microservice REST API (reference: wrapper.oas3.json)."""
    return {
        "openapi": "3.0.0",
        "info": {"title": "seldon-core-tpu node microservice API", "version": __version__},
        "paths": {
            "/predict": _message_op("model prediction"),
            "/transform-input": _message_op("input transformation"),
            "/transform-output": _message_op("output transformation"),
            "/route": _message_op("routing decision"),
            "/aggregate": _message_op("combine child outputs", "SeldonMessageList"),
            "/send-feedback": _message_op("reward feedback", "Feedback"),
            "/health/ping": {"get": {"summary": "liveness", "responses": {"200": {"description": "pong"}}}},
            "/health/status": {"get": {"summary": "component health", "responses": {"200": {"description": "status"}}}},
            "/metrics": {"get": {"summary": "prometheus metrics", "responses": {"200": {"description": "text exposition"}}}},
        },
        "components": {"schemas": _SCHEMAS},
    }


def gateway_openapi() -> Dict[str, Any]:
    """The external deployment API (reference: engine.oas3.json)."""
    return {
        "openapi": "3.0.0",
        "info": {"title": "seldon-core-tpu deployment API", "version": __version__},
        "paths": {
            "/api/v0.1/predictions": _message_op("graph prediction"),
            "/api/v0.1/feedback": _message_op("reward feedback", "Feedback"),
            "/api/v0.1/explanations": _message_op("model explanation"),
            "/ping": {"get": {"summary": "liveness", "responses": {"200": {"description": "pong"}}}},
            "/ready": {"get": {"summary": "graph readiness", "responses": {"200": {"description": "ready"}, "503": {"description": "not ready"}}}},
            "/metrics": {"get": {"summary": "prometheus metrics", "responses": {"200": {"description": "text exposition"}}}},
        },
        "components": {"schemas": _SCHEMAS},
    }
