"""The fleet telemetry CLI — the port of ``scripts/zoo-fleet``.

    python -m analytics_zoo_tpu_torch.observability.fleet_cli watch
        [endpoint ...] [--interval S] [--iterations N] [--fleetz-port P]
        [--window S] [--registry-stream S]
    python -m analytics_zoo_tpu_torch.observability.fleet_cli check
        [endpoint ...] [--json] [--window S] [--registry-stream S]

Where the status CLI (``serving/status.py``) is one scrape pretty-printed,
this runs a :class:`~analytics_zoo_tpu_torch.observability.FleetCollector`
in-process: replicas scraped on a cadence under per-target retry and
circuit breakers, series in the ring-buffer store, the default alert
ruleset evaluated every pass.

``watch`` prints a live fleet table every ``--interval`` seconds
(per-replica health, breaker, depth, pending, utilization, goodput and
batch target; windowed fleet rates; the saturation verdict; each alert
transition as it happens); ``--iterations N`` stops after N polls (0 =
until interrupted) and ``--fleetz-port P`` also serves ``/fleetz``, the
fleet ``/metrics`` and ``/healthz``. ``check`` is the one-shot gate: two
quick polls (windowed rates need two samples), the rules at zero hold
time, the alert table, or the ``/fleetz`` document under ``--json``.

Endpoints (``host:port``, a bare port or a URL; default
127.0.0.1:9464) are scraped as given; ``--registry-stream S`` also
discovers replicas from that stream's fleet registry through the
process's default serving backend.

The subcommands, flags, output and exit codes are the JAX script's; this
copy imports only the port.

Exit status (check): 0 healthy, 1 no replica reachable, 3 alert(s)
firing.
"""

import argparse
import json
import sys
import time

from . import (FleetCollector, FleetzServer, MetricsRegistry, base_url,
               default_ruleset)

DEFAULT = "127.0.0.1:9464"


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.observability.fleet_cli",
        description="Fleet telemetry: live collector watch table and "
                    "one-shot alert gate.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    watch = sub.add_parser(
        "watch", help="live fleet table + alert transition log")
    check = sub.add_parser(
        "check", help="one-shot poll; exit 3 if any alert fires")
    for p in (watch, check):
        p.add_argument("endpoints", nargs="*", default=[DEFAULT],
                       metavar="endpoint",
                       help="host:port, bare port, or URL "
                            f"(default {DEFAULT})")
        p.add_argument("--window", type=float, default=60.0,
                       metavar="S",
                       help="rate/slope window in seconds "
                            "(default 60)")
        p.add_argument("--registry-stream", default=None, metavar="S",
                       help="also discover replicas from this fleet "
                            "registry stream via the configured "
                            "serving backend")
    watch.add_argument("--interval", type=float, default=2.0,
                       metavar="S",
                       help="seconds between polls (default 2)")
    watch.add_argument("--iterations", type=int, default=0,
                       metavar="N",
                       help="stop after N polls (default 0 = forever)")
    watch.add_argument("--fleetz-port", type=int, default=None,
                       metavar="P",
                       help="also serve /fleetz + fleet /metrics + "
                            "/healthz on this port (0 = pick free)")
    check.add_argument("--json", action="store_true",
                       help="emit the full /fleetz JSON document "
                            "instead of the table")
    return ap.parse_args(argv)


def _collector(args, interval_s):
    """A FleetCollector wired with the default ruleset (zero hold time
    for check so one-shot breaches fire immediately)."""
    backend = stream = None
    if args.registry_stream:
        from ..serving import default_backend
        backend = default_backend()
        stream = args.registry_stream
    hold = 0.0 if args.cmd == "check" else 2.0 * interval_s
    return FleetCollector(
        endpoints=[_norm(e) for e in (args.endpoints or [DEFAULT])],
        backend=backend, stream=stream,
        registry=MetricsRegistry(),
        interval_s=interval_s,
        rules=default_ruleset(for_s=hold, replica_down_for_s=hold))


def _norm(endpoint):
    return base_url(endpoint).replace("http://", "")


def _fmt_util(u):
    return "?" if u is None else f"{u * 100.0:.0f}%"


def _fmt_rate(r):
    return "?" if r is None else f"{r:.3g}/s"


def _print_table(page):
    """One watch/check frame from a ``fleetz()`` document."""
    fleet = page["fleet"]
    sat = page["saturation"]
    print(f"fleet        : {fleet['replicas_live']} live / "
          f"{fleet['replicas_down']} down / "
          f"{fleet['replicas_seen']} seen"
          f" | verdict {sat['verdict']}"
          + (f" | util mean {_fmt_util(sat['utilization_mean'])}"
             if sat.get("utilization_mean") is not None else "")
          + (f" | depth {sat['depth']:.0f}"
             if sat.get("depth") is not None else ""))
    print(f"{'replica':<28} {'ok':>3} {'breaker':>9} {'depth':>6} "
          f"{'pending':>8} {'util':>6} {'goodput':>8} {'batch':>6}")
    for ep, r in sorted(page["replicas"].items()):
        sc = r.get("scaling") or {}
        print(f"{ep:<28} {('ok' if r['healthy'] else 'DOWN'):>4} "
              f"{r['breaker']:>9} "
              f"{str(sc.get('stream_depth', '?')):>6} "
              f"{str(sc.get('pending_entries', '?')):>8} "
              f"{_fmt_util(sc.get('utilization')):>6} "
              f"{_fmt_util(sc.get('goodput')):>8} "
              f"{str(sc.get('batch_size_target', '?')):>6}"
              + (f"  ({r['error']})" if r.get("error") else ""))
    rates = page["rates"]
    parts = []
    for fam in sorted(rates):
        short = fam.replace("zoo_serving_", "").replace("_total", "")
        parts.append(f"{short} {_fmt_rate(rates[fam])}")
    print("rates        : " + " | ".join(parts))


def _print_alerts(page):
    alerts = page.get("alerts") or {}
    active = {n: a for n, a in alerts.items()
              if a["state"] != "inactive"}
    if not active:
        print("alerts       : all inactive")
        return
    for name in sorted(active):
        a = active[name]
        v = a.get("value")
        print(f"alerts       : {a['state'].upper():>7} {name}"
              f" (value {v if v is None else f'{v:g}'}"
              f" vs {a['threshold']:g}, severity {a['severity']})")


def _drain_transitions(collector, seen):
    """Print alert transitions appended since ``seen``; returns the
    new watermark."""
    log = collector.transitions_log
    seen = min(seen, len(log))
    for tr in log[seen:]:
        print(f"ALERT        : {tr['state']:>8} {tr['alert']} "
              f"at {tr['ts']:.1f}"
              + (f" (value {tr['value']:g})"
                 if tr.get("value") is not None else ""))
    return len(log)


def _watch(args):
    collector = _collector(args, args.interval)
    server = None
    if args.fleetz_port is not None:
        server = FleetzServer(collector, port=args.fleetz_port)
        print(f"zoo-fleet: serving {server.url} "
              f"(and /metrics, /healthz)")
    seen = 0
    n = 0
    try:
        while True:
            collector.poll()
            n += 1
            print(f"\n== poll {n} @ {time.strftime('%H:%M:%S')} ==")
            page = collector.fleetz(window_s=args.window)
            _print_table(page)
            _print_alerts(page)
            seen = _drain_transitions(collector, seen)
            if args.iterations and n >= args.iterations:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        if server is not None:
            server.close()
    return 0


def _check(args):
    collector = _collector(args, 0.2)
    ok = collector.poll()
    time.sleep(0.2)             # second sample: windowed rates need 2
    ok = max(ok, collector.poll())
    page = collector.fleetz(window_s=args.window)
    if args.json:
        print(json.dumps(page, indent=2, default=str))
    else:
        _print_table(page)
        _print_alerts(page)
        _drain_transitions(collector, 0)
    if not ok:
        # a fleet with NOTHING reachable is the status CLI's exit-1
        # contract, not an alert page (replica_down would always fire)
        print("zoo-fleet: no replica reachable", file=sys.stderr)
        return 1
    firing = [n for n, a in (page.get("alerts") or {}).items()
              if a["state"] == "firing"]
    if firing:
        print(f"zoo-fleet: {len(firing)} alert(s) firing: "
              + ", ".join(sorted(firing)), file=sys.stderr)
        return 3
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    return _watch(args) if args.cmd == "watch" else _check(args)


if __name__ == "__main__":
    sys.exit(main())
