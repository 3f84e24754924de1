"""Replay a request capture container on the port.

``utils/capture.py`` stores one SRT1 container per captured request: the
prompt, the per-request seed the serving component mixed, the sampling
recipe, the adapter, the ``StreamingLM`` constructor config (device and
dtype included) and the knob snapshot of the capturing process.  This
tool rebuilds that component, re-submits the request through the same
ingress (``StreamingLM.predict`` with a ``seed`` tag, so seed mixing and
adapter resolution are the serving code's own) and diffs the outcome:

* **tokens**: a greedy capture (``temperature == 0``) must replay bit for
  bit on the same device and dtype; a sampled one reports its first
  divergence instead of asserting.
* **latency terms**: the replay runs with the capture plane pointed at a
  throwaway store, so the replayed request has its own five phase terms;
  the report diffs queued / prefill / decode / ttft / total.

The replay runs on ``cuda`` unless it is given ``--device cpu`` (asking
for CUDA without a card raises); ``dtype`` is the captured one.  A
container of the JAX package's ``tools/seldon_replay.py`` reads here too.

    python -m seldon_core_tpu_torch.tools.replay /path/to/capture-<puid>-<crc>.srt1
    python -m seldon_core_tpu_torch.tools.replay <puid> --store $SELDON_TPU_CAPTURE_DIR [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
from typing import Any, Dict, List, Optional

# knobs a replay does not inherit from the capturing process: the capture
# plane's own (the replay wires a throwaway store) and the paths where the
# incident process wrote (a replay must not write into them)
_SKIP_KNOB_PREFIXES = ("SELDON_TPU_CAPTURE",)
_SKIP_KNOBS = {"SELDON_TPU_DRAIN_JOURNAL", "SELDON_TPU_TRACE_EXPORT", "SELDON_TPU_DUMP_DIR",
               "SELDON_TPU_PROFILE_DIR"}
PHASE_TERMS = ("queued_ms", "prefill_ms", "decode_ms", "ttft_ms", "total_ms")


def _skip_knob(name: str) -> bool:
    """A knob the replay leaves alone: a skipped one, or one this package
    does not declare (a capture of the JAX package may carry those)."""
    from seldon_core_tpu_torch.runtime import knobs

    return name in _SKIP_KNOBS or name.startswith(_SKIP_KNOB_PREFIXES) or not knobs.declared(name)


def first_divergence(a, b) -> Optional[int]:
    """Index of the first differing token, None when equal (a length
    difference diverges at the shorter length)."""
    import numpy as np

    a = np.asarray(a, np.int64).reshape(-1)
    b = np.asarray(b, np.int64).reshape(-1)
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    if neq.size:
        return int(neq[0])
    return n if a.size != b.size else None


def load_capture(source: str, store_dir: str = ""):
    """A capture from a container path, or from a puid looked up in
    ``store_dir`` (default ``SELDON_TPU_CAPTURE_DIR``)."""
    from seldon_core_tpu_torch.runtime import knobs
    from seldon_core_tpu_torch.utils.capture import CaptureStore

    if os.path.isfile(source):
        cap = CaptureStore.load(source)
        if cap is None:
            raise SystemExit(f"unreadable capture container: {source}")
        return cap
    root = store_dir or knobs.raw("SELDON_TPU_CAPTURE_DIR", "") or ""
    if not root:
        raise SystemExit(f"{source!r} is not a file and no store directory is set (--store / SELDON_TPU_CAPTURE_DIR)")
    cap = CaptureStore(root=root).get(source)
    if cap is None:
        raise SystemExit(f"no capture for puid {source!r} under {root}")
    return cap


def replay_capture(cap, *, strict: Optional[bool] = None, device: str = "cuda") -> Dict[str, Any]:
    """Re-execute one capture on ``device`` and return the diff report
    (``bit_exact``, ``first_divergence``, both token rows, the per-term
    latency diff).  ``strict`` asserts bit-exactness (default: exactly
    when the capture is greedy)."""
    import numpy as np

    from seldon_core_tpu_torch.utils import capture as capture_mod

    prompt = np.asarray([] if cap.prompt is None else cap.prompt, np.int32).reshape(-1)
    if prompt.size == 0:
        return {"puid": cap.puid, "replayable": False,
                "info": "capture has no prompt frame (SELDON_TPU_CAPTURE_PAYLOADS=0 at capture time)"}
    if cap.seed is None:
        return {"puid": cap.puid, "replayable": False, "info": "capture carries no request seed"}
    greedy = float(cap.temperature or 0.0) == 0.0
    if strict is None:
        strict = greedy
    touched: Dict[str, Optional[str]] = {}

    def setenv(name: str, value: Optional[str]) -> None:
        if name not in touched:
            touched[name] = os.environ.get(name)
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value

    replay_store = tempfile.mkdtemp(prefix="seldon-tpu-replay-")
    lm = None
    try:
        # the capturing process's set knobs: the replayed engine resolves
        # its env-driven shape (kernel lane, chunk, budget, cache) as it did
        applied: List[str] = []
        for k in cap.knobs or []:
            name = str(k.get("name", ""))
            if not name or _skip_knob(name):
                continue
            setenv(name, str(k.get("value", "")))
            applied.append(name)
        # a throwaway capture plane: the replayed request's own container
        # gives its phase terms
        setenv("SELDON_TPU_CAPTURE", "1")
        setenv("SELDON_TPU_CAPTURE_SAMPLE", "1")
        setenv("SELDON_TPU_CAPTURE_PAYLOADS", "1")
        setenv("SELDON_TPU_CAPTURE_DIR", replay_store)
        capture_mod.reset_default_store()

        from seldon_core_tpu_torch.models.paged import StreamingLM

        model_cfg = dict(cap.model or {}, device=device)
        lm = StreamingLM(**model_cfg)
        tags: Dict[str, Any] = {"seed": int(cap.seed), "max_new_tokens": int(cap.max_new_tokens),
                                "temperature": float(cap.temperature), "top_k": int(cap.top_k)}
        if cap.adapter:
            tags["adapter"] = cap.adapter
        if cap.priority:
            tags["priority"] = int(cap.priority)
        result = lm.predict(prompt.reshape(1, -1), [], meta={"puid": cap.puid, "tags": tags})
        replayed = np.asarray(result[0], np.int32).reshape(-1)
        stats = lm.engine.engine_stats()
        captured = np.asarray([] if cap.tokens is None else cap.tokens, np.int32).reshape(-1)
        divergence = first_divergence(captured, replayed)
        replay_cap = capture_mod.CaptureStore(root=replay_store).get(cap.puid)
        latency: Dict[str, Any] = {}
        if replay_cap is not None:
            for term in PHASE_TERMS:
                was = (cap.phases or {}).get(term)
                now = (replay_cap.phases or {}).get(term)
                latency[term] = {"captured": was, "replayed": now,
                                 "delta": round(now - was, 3) if was is not None and now is not None else None}
        report = {
            "puid": cap.puid, "replayable": True, "greedy": greedy, "status_at_capture": cap.status,
            "trigger": cap.trigger, "adapter": cap.adapter, "seed": cap.seed, "device": str(lm.device),
            "dtype": lm.dtype_name, "knobs_applied": applied, "bit_exact": divergence is None,
            "first_divergence": divergence, "captured_tokens": captured.tolist(),
            "replayed_tokens": replayed.tolist(), "latency": latency,
            # the replay engine's decode lane and its calls (its warm-up's too)
            "engine": {k: stats[k] for k in ("kernel_active", "chunks", "tokens", "chunk_steps", "bucketed_steps")},
        }
        if strict and divergence is not None:
            raise AssertionError(f"greedy replay diverged at token {divergence}: captured={captured.tolist()} "
                                 f"replayed={replayed.tolist()}")
        return report
    finally:
        if lm is not None:
            lm.unload()
        for name, old in touched.items():
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old
        capture_mod.reset_default_store()
        shutil.rmtree(replay_store, ignore_errors=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", help="capture container path, or a puid resolved via --store")
    ap.add_argument("--store", default="", help="capture store directory for puid lookups "
                                                "(default: $SELDON_TPU_CAPTURE_DIR)")
    ap.add_argument("--device", default="cuda", help="device to replay on (default cuda; 'cpu' for no card)")
    ap.add_argument("--no-strict", action="store_true", help="report instead of asserting on greedy divergence")
    ap.add_argument("--json", action="store_true", help="machine output")
    args = ap.parse_args(argv)
    cap = load_capture(args.source, store_dir=args.store)
    report = replay_capture(cap, strict=False if args.no_strict else None, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, default=str))
        return 0 if report.get("bit_exact", not report["replayable"]) else 1
    if not report["replayable"]:
        print(f"[replay] {report['puid']}: not replayable: {report['info']}")
        return 2
    print(f"[replay] puid={report['puid']} trigger={report['trigger']} greedy={report['greedy']} "
          f"adapter={report['adapter'] or '-'} device={report['device']} dtype={report['dtype']}")
    if report["bit_exact"]:
        print(f"[replay] tokens: bit-exact ({len(report['captured_tokens'])} tokens)")
    else:
        print(f"[replay] tokens: diverged at index {report['first_divergence']}")
    for term, d in report["latency"].items():
        print(f"[replay] {term:>11}: captured={d['captured']} replayed={d['replayed']} delta={d['delta']}")
    return 0 if report["bit_exact"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
