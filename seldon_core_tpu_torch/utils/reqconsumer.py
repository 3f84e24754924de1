"""Request-logger consumer: ingest + index + query CloudEvents pairs.

The reference ships a consumer service that receives the engine's
request/response pair POSTs and indexes flattened rows into
Elasticsearch (reference: seldon-request-logger/app/app.py:15-60 —
flatten, derive the index from CE headers, upsert by puid).  This is
the port's copy of the JAX package's consumer, with SQLite standing in
for ES: same ingestion surface (CloudEvents POST), same
queryability contract (find the full pair by puid, scan by time), plus
a JSONL-file lane for the ``JsonlPairLogger`` output.

Surfaces:

* :class:`PairIndex` — the store: one row per pair, keyed by puid
  (last-write-wins upsert, the reference's ES doc-id semantics),
  flattened columns for the fields dashboards filter on.
* :class:`build_consumer_app` — aiohttp app: ``POST /`` ingests a
  CloudEvents pair (the HttpPairLogger's wire shape), ``GET
  /pairs/{puid}`` and ``GET /pairs?since=&until=&limit=`` query.
* CLI ``seldon-tpu-reqlog`` — ``serve`` (the consumer daemon),
  ``ingest`` (index a JSONL pair file), ``query`` (by puid or range).
"""

from __future__ import annotations

import json
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS pairs (
    puid TEXT PRIMARY KEY,
    time REAL NOT NULL,
    predictor TEXT,
    request_path TEXT,
    status TEXT,
    request_json TEXT NOT NULL,
    response_json TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS pairs_time ON pairs (time);
"""


def _flatten(pair: Dict[str, Any]) -> Dict[str, Any]:
    """Row fields derived from a pair (the reference's flattening step,
    app.py:15-60 — here the filterable columns, with the full JSON kept
    alongside)."""
    request = pair.get("request") or {}
    response = pair.get("response") or {}
    meta = response.get("meta") or {}
    tags = meta.get("tags") or {}
    status = response.get("status") or {}
    puid = pair.get("puid") or meta.get("puid") or (request.get("meta") or {}).get("puid")
    return {
        "puid": str(puid or ""),
        "time": float(pair.get("time") or time.time()),
        "predictor": str(tags.get("predictor") or ""),
        "request_path": json.dumps(meta.get("requestPath") or {}),
        "status": str(status.get("status") or "SUCCESS"),
        "request_json": json.dumps(request),
        "response_json": json.dumps(response),
    }


class PairIndex:
    """SQLite-backed pair store (thread-safe; ``:memory:`` for tests)."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.executescript(_SCHEMA)
        self._lock = threading.Lock()

    def ingest(self, pair: Dict[str, Any]) -> str:
        """Index one pair; returns its puid.  Pairs without a puid are
        rejected — they can never be queried back, so accepting them
        would silently lose data (the reference derives its ES doc id
        from the puid for the same reason)."""
        row = _flatten(pair)
        if not row["puid"]:
            raise ValueError("pair carries no puid (response.meta.puid empty)")
        with self._lock:
            self._conn.execute(
                "INSERT INTO pairs (puid, time, predictor, request_path, status,"
                " request_json, response_json) VALUES (?,?,?,?,?,?,?)"
                " ON CONFLICT(puid) DO UPDATE SET time=excluded.time,"
                " predictor=excluded.predictor, request_path=excluded.request_path,"
                " status=excluded.status, request_json=excluded.request_json,"
                " response_json=excluded.response_json",
                (row["puid"], row["time"], row["predictor"], row["request_path"],
                 row["status"], row["request_json"], row["response_json"]),
            )
            self._conn.commit()
        return row["puid"]

    def ingest_jsonl(self, path: str) -> int:
        """Index a ``JsonlPairLogger`` file; returns rows indexed."""
        n = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                self.ingest(json.loads(line))
                n += 1
        return n

    def get(self, puid: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            cur = self._conn.execute(
                "SELECT puid, time, predictor, request_path, status,"
                " request_json, response_json FROM pairs WHERE puid = ?",
                (puid,),
            )
            row = cur.fetchone()
        return self._row_to_dict(row) if row else None

    def query(
        self,
        since: Optional[float] = None,
        until: Optional[float] = None,
        predictor: Optional[str] = None,
        limit: int = 100,
    ) -> List[Dict[str, Any]]:
        clauses, args = [], []
        if since is not None:
            clauses.append("time >= ?")
            args.append(float(since))
        if until is not None:
            clauses.append("time <= ?")
            args.append(float(until))
        if predictor:
            clauses.append("predictor = ?")
            args.append(predictor)
        where = (" WHERE " + " AND ".join(clauses)) if clauses else ""
        args.append(int(limit))
        with self._lock:
            cur = self._conn.execute(
                "SELECT puid, time, predictor, request_path, status,"
                f" request_json, response_json FROM pairs{where}"
                " ORDER BY time DESC LIMIT ?",
                args,
            )
            rows = cur.fetchall()
        return [self._row_to_dict(r) for r in rows]

    def count(self) -> int:
        with self._lock:
            return self._conn.execute("SELECT COUNT(*) FROM pairs").fetchone()[0]

    @staticmethod
    def _row_to_dict(row) -> Dict[str, Any]:
        return {
            "puid": row[0],
            "time": row[1],
            "predictor": row[2],
            "requestPath": json.loads(row[3] or "{}"),
            "status": row[4],
            "request": json.loads(row[5]),
            "response": json.loads(row[6]),
        }

    def close(self) -> None:
        with self._lock:
            self._conn.close()


def build_consumer_app(index: PairIndex):
    """aiohttp app: the CloudEvents ingestion + query surface."""
    from aiohttp import web

    async def ingest(request: web.Request) -> web.Response:
        try:
            pair = await request.json()
        except Exception:  # noqa: BLE001 — malformed body maps to 400
            return web.json_response({"error": "body is not JSON"}, status=400)
        ce_type = request.headers.get("CE-Type", "")
        if ce_type and ce_type != "seldon.message.pair":
            return web.json_response(
                {"error": f"unsupported CE-Type {ce_type!r}"}, status=400
            )
        try:
            puid = index.ingest(pair)
        except (ValueError, TypeError) as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"indexed": puid})

    async def get_pair(request: web.Request) -> web.Response:
        pair = index.get(request.match_info["puid"])
        if pair is None:
            return web.json_response({"error": "not found"}, status=404)
        return web.json_response(pair)

    async def list_pairs(request: web.Request) -> web.Response:
        q = request.query

        def num(name):
            return float(q[name]) if name in q else None

        try:
            rows = index.query(
                since=num("since"), until=num("until"),
                predictor=q.get("predictor") or None,
                limit=int(q.get("limit", "100")),
            )
        except ValueError as e:
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response({"count": len(rows), "pairs": rows})

    async def stats(_r: web.Request) -> web.Response:
        return web.json_response({"pairs": index.count()})

    app = web.Application(client_max_size=64 * 1024 * 1024)
    app.router.add_post("/", ingest)
    app.router.add_post("/api/v0.1/pairs", ingest)  # explicit alias
    app.router.add_get("/pairs/{puid}", get_pair)
    app.router.add_get("/pairs", list_pairs)
    app.router.add_get("/stats", stats)
    return app


def main(argv: Optional[List[str]] = None) -> None:
    """CLI: seldon-tpu-reqlog serve|ingest|query"""
    import argparse

    parser = argparse.ArgumentParser(description="request-pair log consumer")
    parser.add_argument("--db", default="pairs.sqlite", help="index database path")
    sub = parser.add_subparsers(dest="command", required=True)
    serve_p = sub.add_parser("serve", help="run the CloudEvents consumer daemon")
    serve_p.add_argument("--host", default="0.0.0.0")
    serve_p.add_argument("--port", type=int, default=8085)
    ingest_p = sub.add_parser("ingest", help="index a JsonlPairLogger file")
    ingest_p.add_argument("jsonl", help="pair file (one JSON object per line)")
    query_p = sub.add_parser("query", help="query indexed pairs")
    query_p.add_argument("--puid", default=None)
    query_p.add_argument("--since", type=float, default=None)
    query_p.add_argument("--until", type=float, default=None)
    query_p.add_argument("--predictor", default=None)
    query_p.add_argument("--limit", type=int, default=20)
    args = parser.parse_args(argv)

    index = PairIndex(args.db)
    if args.command == "ingest":
        n = index.ingest_jsonl(args.jsonl)
        print(f"indexed {n} pairs into {args.db}")
    elif args.command == "query":
        if args.puid:
            pair = index.get(args.puid)
            print(json.dumps(pair, indent=2) if pair else f"no pair with puid {args.puid!r}")
        else:
            rows = index.query(since=args.since, until=args.until,
                               predictor=args.predictor, limit=args.limit)
            for row in rows:
                print(json.dumps({k: row[k] for k in
                                  ("puid", "time", "predictor", "status")}))
            print(f"({len(rows)} pairs)")
    else:  # serve
        from aiohttp import web

        web.run_app(build_consumer_app(index), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
