"""Live-stream evacuation: the coordinator ``StreamingLM.evacuate`` runs.

The port's part of ``seldon_core_tpu/models/disagg.py``: the journal
entry of a migration payload, the placement cost of a peer, and
:func:`evacuate_streams`, which moves a draining engine's mid-decode
streams onto peer engines in this process (KV pages, decode cursor and
sampler state included) and journals the ones no peer takes.

Not ported yet: ``PrefillLM`` and ``DisaggregatedLM``, the disaggregated
prefill/decode components that ride ``PagedEngine.prefill_export`` /
``submit_prefilled`` (``ROADMAP.md`` §A item A10).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List

import numpy as np

from seldon_core_tpu_torch.models.paged import PagedEngine, journal_entry
from seldon_core_tpu_torch.runtime.component import MicroserviceError

logger = logging.getLogger(__name__)

__all__ = ["evacuate_streams", "migration_journal_entry"]


def _count(x) -> int:
    return int(np.asarray(x if x is not None else []).reshape(-1).shape[0])


def migration_journal_entry(payload: Dict[str, Any]) -> Dict[str, Any]:
    """A drain-journal entry from a migration payload: the recipe a
    stream falls back to when no peer takes it.  The schema is the one
    :func:`models.paged.journal_entry` builds, so the drain lane and the
    migration lane journal alike."""
    return journal_entry(
        req_id=payload.get("req_id"),
        prompt=[int(t) for t in np.asarray(payload["prompt"]).reshape(-1)],
        max_new_tokens=int(payload.get("max_new_tokens", 32)),
        temperature=float(payload.get("temperature", 0.0)),
        top_k=int(payload.get("top_k", 0)),
        eos_id=int(payload.get("eos_id", -1)),
        seed=int(payload.get("seed", 0)),
        priority=int(payload.get("priority", 0)),
        deadline_remaining_ms=payload.get("deadline_remaining_ms"),
        streamed=int(payload.get("streamed") or 0),
        stream_tokens=bool(payload.get("stream_tokens")),
        tokens_decoded=_count(payload.get("tokens")),
        adapter=payload.get("adapter"),
    )


def _peer_cost_s(engine: PagedEngine, payload: Dict[str, Any]) -> float:
    """Predicted seconds of ``payload``'s remaining decode on ``engine``
    from its measured rates (the KV arrives computed, so no prefill); a
    cold peer prices 0.  Its backlog breaks ties, so one peer does not
    take the whole wave."""
    remaining = max(1, int(payload.get("max_new_tokens", 32)) - _count(payload.get("tokens")))
    cost = engine.predict_cost_s(0, remaining)
    stats = engine.engine_stats()
    return (cost or 0.0) + 0.001 * (stats["queued"] + stats["active"])


def evacuate_streams(src_engine: PagedEngine, peers: List[PagedEngine], *,
                     transport: str = "local") -> Dict[str, Any]:
    """Live-migrate ``src_engine``'s exportable streams onto the healthy
    ``peers`` (``engine_stats()["health"]``, the watchdog's state: a
    degraded or evacuating peer takes none), highest priority first, each
    to the peer whose predicted remaining cost is lowest.  The peer adopts the source's stream
    object, so waiters and token queues carry on: no token is lost.  A
    stream every peer refuses (pool too small, engine closed, shed, a
    sampler state of another kind) resolves 503 ``MIGRATING`` and its
    recipe lands in the returned ``journal``.  Returns ``{"migrated",
    "failed", "journal"}``."""
    from seldon_core_tpu_torch.engine.transport import migration_hop

    exported = src_engine.migrate_export()
    healthy = [p for p in peers
               if p is not src_engine and p.engine_stats().get("health", "healthy") == "healthy"]
    out: Dict[str, Any] = {"migrated": 0, "failed": 0, "journal": []}
    err = MicroserviceError("stream could not be live-migrated during evacuation; its recipe is journaled for "
                            "re-derivation", status_code=503, reason="MIGRATING")
    for payload, stream in sorted(exported, key=lambda ps: -ps[0]["priority"]):
        placed = False
        for peer in sorted(healthy, key=lambda p: _peer_cost_s(p, payload)):
            try:
                with migration_hop("evacuate", transport) as hop:
                    if hop is not None:
                        hop.zero_copy_bytes = payload["k"].nbytes + payload["v"].nbytes
                    peer.migrate_import(payload, stream=stream)
                placed = True
                break
            except MicroserviceError as exc:
                logger.warning("peer refused migrated req %s: %s", payload.get("req_id"), exc)
        if placed:
            out["migrated"] += 1
        else:
            out["failed"] += 1
            out["journal"].append(migration_journal_entry(payload))
            src_engine.fail_stream(stream, err)
    return out
