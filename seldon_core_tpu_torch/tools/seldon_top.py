"""Fleet top: a terminal view of the fleet telemetry plane.

Polls the gateway's ``GET /debug/fleet`` (or, with ``--endpoints``,
builds its own in-process :class:`TelemetryAggregator` and polls the
replicas' ``/debug/telemetry`` directly — no gateway required) and
renders one row per replica: freshness state, goodput / prefill tok/s,
queue depth, slot and KV-pool occupancy, prefix hit rate, resident
adapters, and KV page-seconds/s (the cost ledger's burn rate), topped
by the fleet rollup line the autoscaler would read.

Run:  python -m seldon_core_tpu_torch.tools.seldon_top --gateway http://localhost:8000
      python -m seldon_core_tpu_torch.tools.seldon_top --endpoints r0=http://h0:9000,r1=http://h1:9000
      python -m seldon_core_tpu_torch.tools.seldon_top --gateway ... --once --json   # scripting
"""

import argparse
import json
import sys
import time
import urllib.request

CLEAR = "\x1b[2J\x1b[H"
STATE_GLYPH = {"ok": " ", "stale": "?", "incompatible": "!", "never": "-"}


def fetch_gateway(base: str, timeout_s: float) -> dict:
    url = f"{base.rstrip('/')}/debug/fleet"
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode("utf-8"))


def build_aggregator(endpoints: str, poll_s: float):
    from seldon_core_tpu_torch.controlplane.fleetview import (
        TelemetryAggregator,
        endpoints_from_knob,
    )

    eps = endpoints_from_knob(endpoints)
    if not eps:
        raise SystemExit("no replica endpoints parsed from --endpoints")
    return TelemetryAggregator(endpoints=eps, poll_s=poll_s)


def _pct(used, total) -> str:
    total = float(total or 0)
    return f"{100.0 * float(used or 0) / total:5.1f}%" if total else "    -"


def _bytes(n) -> str:
    """Human bytes for the HOSTKV column; '-' when the replica runs
    with the KV tier off (key absent from its snapshot)."""
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "K", "M", "G", "T"):
        if n < 1024.0 or unit == "T":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n:.1f}T"


def render(view: dict) -> str:
    roll = view.get("rollup", {})
    lines = [
        "seldon-tpu fleet  replicas {}/{} ok  goodput {:.1f} tok/s  "
        "queue {:.0f}  sat max {:.2f}  cost {:.3f} page-s/s".format(
            roll.get("replicas_ok", 0), roll.get("replicas_total", 0),
            roll.get("fleet_goodput_tok_s", 0.0),
            roll.get("fleet_queue_depth", 0.0),
            roll.get("fleet_saturation_max", 0.0),
            roll.get("fleet_cost_page_s_s", 0.0),
        ),
        "",
        "  {:<16} {:<6} {:>9} {:>9} {:>6} {:>7} {:>7} {:>7} {:>8} "
        "{:>10}  {}".format(
            "REPLICA", "STATE", "GOOD t/s", "PREF t/s", "QUEUE",
            "SLOTS", "KV%", "HIT%", "HOSTKV", "COST p-s/s", "ADAPTERS",
        ),
    ]
    for name in sorted(view.get("replicas", {})):
        r = view["replicas"][name]
        p = r.get("latest") or {}
        lines.append(
            " {}{:<16} {:<6} {:>9.1f} {:>9.1f} {:>6d} {:>4d}/{:<2d} {:>7} "
            "{:>6.1f} {:>8} {:>10.3f}  {}".format(
                STATE_GLYPH.get(r.get("state"), " "), name[:16],
                r.get("state", "?"),
                float(p.get("goodput_tok_s", 0.0)),
                float(p.get("prefill_tok_s", 0.0)),
                int(p.get("queue_depth", 0)),
                int(p.get("active_slots", 0)),
                int(p.get("active_slots_total", 0)),
                _pct(p.get("pool_pages_used"), p.get("pool_pages_total")),
                float(p.get("prefix_hit_pct", 0.0)),
                _bytes(p.get("kv_tier_host_bytes")),
                float(p.get("cost_page_s_s", 0.0)),
                ",".join(p.get("adapters") or []) or "-",
            )
        )
        if r.get("last_err"):
            lines.append(f"    last_err: {r['last_err']}")
    adapters = view.get("adapters") or {}
    if adapters:
        lines.append("")
        lines.append("  adapter residency: " + "  ".join(
            f"{a}->{','.join(reps)}" for a, reps in adapters.items()))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--gateway", default="",
                    help="gateway base URL serving /debug/fleet")
    ap.add_argument("--endpoints", default="",
                    help="direct replica endpoints (name=url,name=url); "
                         "bypasses the gateway")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh interval seconds (default 2)")
    ap.add_argument("--timeout", type=float, default=3.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the raw fleet view as JSON instead of a table")
    args = ap.parse_args(argv)

    if not args.gateway and not args.endpoints:
        ap.error("need --gateway or --endpoints")

    agg = None
    if args.endpoints:
        agg = build_aggregator(args.endpoints, args.interval)

    try:
        while True:
            if agg is not None:
                view = agg.poll_once()
            else:
                view = fetch_gateway(args.gateway, args.timeout)
            if args.as_json:
                out = json.dumps(view, indent=2, sort_keys=True)
            else:
                out = render(view)
            if args.once:
                print(out)
                return 0
            sys.stdout.write(CLEAR + out + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
