"""Contract tester — schema-driven request generation.

Equivalent of the reference's ``seldon-core-tester`` / contract.json
flow (reference: python/seldon_core/microservice_tester.py:15-289,
api_tester.py:1-167): a contract declares the feature schema; the
tester generates random conforming batches, fires them at a
microservice or a deployment gateway (REST or gRPC), and checks
responses decode and carry a SUCCESS status.

Contract format (a superset of the reference's):

    {
      "features": [
        {"name": "f0", "dtype": "float64", "range": [0, 1]},
        {"name": "pix", "dtype": "uint8", "range": [0, 255], "shape": [224, 224, 3]}
      ],
      "targets": [ ... same schema, used for feedback truth ... ]
    }
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.client.client import ClientResponse, SeldonTpuClient


class ContractError(ValueError):
    pass


@dataclass
class Contract:
    features: List[Dict[str, Any]]
    targets: List[Dict[str, Any]] = field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Contract":
        with open(path) as f:
            raw = json.load(f)
        if "features" not in raw:
            raise ContractError("contract must declare 'features'")
        return cls(features=raw["features"], targets=raw.get("targets", []))

    def feature_names(self) -> List[str]:
        return [f.get("name", f"f{i}") for i, f in enumerate(self.features)]

    def generate_batch(self, n: int, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Random batch conforming to the feature schema.

        Scalar features concatenate into a (n, n_features) matrix; a
        single tensor-shaped feature yields (n, *shape).
        """
        rng = rng or np.random.default_rng()
        shaped = [f for f in self.features if f.get("shape")]
        if shaped:
            if len(self.features) != 1:
                raise ContractError("a shaped feature must be the only feature")
            f = shaped[0]
            return _generate(f, (n, *f["shape"]), rng)
        cols = [_generate(f, (n, 1), rng) for f in self.features]
        return np.concatenate(cols, axis=1)


def _generate(feature: Dict[str, Any], shape, rng: np.random.Generator) -> np.ndarray:
    dtype = np.dtype(feature.get("dtype", "float64"))
    lo, hi = feature.get("range", [0.0, 1.0])
    if "values" in feature:  # categorical
        return rng.choice(feature["values"], size=shape).astype(dtype)
    if dtype.kind in "iu":
        return rng.integers(int(lo), int(hi) + 1, size=shape).astype(dtype)
    return (rng.random(size=shape) * (hi - lo) + lo).astype(dtype)


def run_contract_test(
    contract: Contract,
    client: SeldonTpuClient,
    n_requests: int = 10,
    batch_size: int = 1,
    endpoint: str = "gateway",  # gateway | microservice
    with_feedback: bool = False,
    seed: Optional[int] = None,
) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    names = contract.feature_names()
    ok = 0
    failures: List[str] = []
    for i in range(n_requests):
        batch = contract.generate_batch(batch_size, rng)
        if endpoint == "gateway":
            resp: ClientResponse = client.predict(batch, names=names)
        else:
            resp = client.microservice("predict", batch, names=names)
        if resp.success:
            ok += 1
            if with_feedback and contract.targets:
                client.feedback(request=batch, response=resp.response, reward=1.0)
        else:
            failures.append(str(resp.raw)[:200])
    return {
        "requests": n_requests,
        "succeeded": ok,
        "failed": n_requests - ok,
        "failures": failures[:5],
    }


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="seldon-tpu-torch-tester", description="seldon-core-tpu contract tester (PyTorch port)")
    parser.add_argument("contract", help="contract.json path")
    parser.add_argument("host", nargs="?", default="127.0.0.1")
    parser.add_argument("port", nargs="?", type=int, default=8000)
    parser.add_argument("--grpc", action="store_true")
    parser.add_argument("--endpoint", choices=("gateway", "microservice"), default="gateway")
    parser.add_argument("-n", "--n-requests", type=int, default=10)
    parser.add_argument("-b", "--batch-size", type=int, default=1)
    parser.add_argument("--feedback", action="store_true")
    args = parser.parse_args(argv)

    contract = Contract.load(args.contract)
    client = SeldonTpuClient(
        host=args.host,
        http_port=args.port,
        grpc_port=args.port,
        transport="grpc" if args.grpc else "rest",
    )
    result = run_contract_test(
        contract,
        client,
        n_requests=args.n_requests,
        batch_size=args.batch_size,
        endpoint=args.endpoint,
        with_feedback=args.feedback,
    )
    print(json.dumps(result, indent=2))
    return 0 if result["failed"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
