"""The DLQ operator CLI — the port of ``scripts/zoo-dlq``: inspect,
replay and purge a serving dead-letter directory (``serving/dlq.py``).

    python -m analytics_zoo_tpu_torch.serving.dlq_cli list DIR
    python -m analytics_zoo_tpu_torch.serving.dlq_cli inspect DIR
        [--segment S] [--replayed]
    python -m analytics_zoo_tpu_torch.serving.dlq_cli replay DIR
        [--host H] [--port P] [--stream S] [--segment S] [--uri U ...]
        [--include-open] [--rate N]
    python -m analytics_zoo_tpu_torch.serving.dlq_cli purge DIR
        [--all --yes]

``list`` prints the segment inventory (state, records, bytes, corrupt
frames); ``inspect`` every replayable record (uri, trace, reason, error,
dtype/shape, age; ``--replayed`` adds retired receipts); ``replay``
re-enqueues dead-lettered records with fresh trace ids onto the input
stream of a Redis-protocol server through ``RedisBackend`` (the in-repo
RESP client when redis-py is absent), paced at ``--rate`` records/s if
given, at most once a segment (renamed ``.replayed`` before its first
record goes); a ``--uri`` filter still retires the whole segment, and
``--include-open`` seals and replays open segments too (only with the
owning server stopped); ``purge`` deletes ``.replayed`` receipts, and
with ``--all --yes`` unreplayed work as well.

The subcommands, flags, output and exit codes are the JAX script's; this
copy imports only the port.

Exit status: 0 ok, 1 usage/IO error, 2 replay re-enqueued nothing.
"""

import argparse
import os
import sys
import time

from ..observability import MetricsRegistry
from .backend import RedisBackend
from .client import INPUT_STREAM
from .dlq import DeadLetterQueue
from .status import _human_bytes


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m analytics_zoo_tpu_torch.serving.dlq_cli",
        description="Inspect, replay, and purge a serving dead-letter "
                    "directory.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="segment inventory")
    p.add_argument("directory")
    p = sub.add_parser("inspect", help="print replayable records")
    p.add_argument("directory")
    p.add_argument("--segment", help="one segment (by file or base name)")
    p.add_argument("--replayed", action="store_true",
                   help="include records from .replayed receipts")
    p = sub.add_parser("replay", help="re-enqueue records onto the input "
                                      "stream (at-most-once per segment)")
    p.add_argument("directory")
    p.add_argument("--host", default="localhost")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument("--stream", default=None,
                   help="input stream name (default: the serving input "
                        "stream)")
    p.add_argument("--segment", help="one segment (by file or base name)")
    p.add_argument("--uri", action="append", default=None,
                   help="replay only this uri (repeatable; the rest of "
                        "the segment is RETIRED unserved)")
    p.add_argument("--include-open", action="store_true",
                   help="seal + replay open segments (server must be "
                        "stopped)")
    p.add_argument("--rate", type=float, default=None,
                   help="pace re-enqueues at N records/second so a "
                        "large replay cannot push the backlog over the "
                        "server's shed watermark (default: unpaced)")
    p = sub.add_parser("purge", help="delete .replayed receipts")
    p.add_argument("directory")
    p.add_argument("--all", action="store_true",
                   help="also delete UNREPLAYED work")
    p.add_argument("--yes", action="store_true",
                   help="required with --all")
    return ap.parse_args(argv)


def _dlq(directory):
    if not os.path.isdir(directory):
        print(f"zoo-dlq: {directory}: not a directory", file=sys.stderr)
        raise SystemExit(1)
    # a private registry: an operator CLI must not pollute (or depend on)
    # the process-wide one
    return DeadLetterQueue(directory, registry=MetricsRegistry())


def cmd_list(args):
    q = _dlq(args.directory)
    segments = q.segments()
    if not segments:
        print(f"{args.directory}: no segments")
        return 0
    print(f"{'segment':<36} {'state':<10} {'records':>8} {'bytes':>10} "
          f"{'corrupt':>8}")
    for s in segments:
        print(f"{s['name']:<36} {s['state']:<10} {s['records']:>8} "
              f"{_human_bytes(s['bytes']):>10} {s['corrupt']:>8}")
    replayable = sum(s["records"] for s in segments
                     if s["state"] != "replayed")
    print(f"\nreplayable: {replayable} record(s) in "
          f"{sum(s['state'] != 'replayed' for s in segments)} segment(s); "
          f"{_human_bytes(sum(s['bytes'] for s in segments))} on disk")
    return 0


def cmd_inspect(args):
    q = _dlq(args.directory)
    now_ms = time.time() * 1000
    n = 0
    for seg, rec in q.scan(segment=args.segment,
                           include_replayed=args.replayed):
        n += 1
        age = (now_ms - rec.get("ts_ms", now_ms)) / 1000.0
        print(f"{rec.get('uri', '?'):<24} reason={rec.get('reason', '?'):<9}"
              f" trace={rec.get('trace') or '-':<17}"
              f" dtype={rec.get('dtype', '?'):<6}"
              f" shape=({rec.get('shape', '?')})"
              f" age={age:.0f}s seg={seg}"
              + (f"\n    error: {rec['error']}" if rec.get("error") else ""))
    if not n:
        print("no records")
    return 0


def cmd_replay(args):
    if args.rate is not None and args.rate <= 0:
        print("zoo-dlq: --rate must be > 0 records/second",
              file=sys.stderr)
        return 1
    q = _dlq(args.directory)
    states = {"sealed"} | ({"open"} if args.include_open else set())
    if not any(s["state"] in states for s in q.segments()):
        # decided BEFORE touching the backend: an empty replay must not
        # masquerade as a connection problem
        print("zoo-dlq: nothing replayed (no sealed segments? pass "
              "--include-open once the server is stopped)", file=sys.stderr)
        return 2
    backend = RedisBackend(host=args.host, port=args.port)
    stream = args.stream or INPUT_STREAM
    n = q.replay(backend, stream=stream, segment=args.segment,
                 uris=args.uri, include_open=args.include_open,
                 rate=args.rate)
    print(f"replayed {n} record(s) onto {stream!r} at "
          f"{args.host}:{args.port}")
    if n == 0:
        print("zoo-dlq: nothing replayed (no sealed segments? pass "
              "--include-open once the server is stopped)", file=sys.stderr)
        return 2
    return 0


def cmd_purge(args):
    if args.all and not args.yes:
        print("zoo-dlq: purge --all deletes UNREPLAYED dead letters — "
              "re-run with --yes to confirm", file=sys.stderr)
        return 1
    q = _dlq(args.directory)
    # only SEALED work is actually destroyed: purge never touches a
    # (possibly live) .open segment, and the give-up receipt must say
    # what was dropped, not what the directory held
    segments = q.segments()
    dropped = sum(s["records"] for s in segments
                  if s["state"] == "sealed") if args.all else 0
    skipped_open = sum(s["records"] for s in segments
                       if s["state"] == "open") if args.all else 0
    removed = q.purge(replayed_only=not args.all)
    print(f"purged {removed} segment(s)"
          + (f" ({dropped} unreplayed record(s) dropped)" if args.all
             else ""))
    if skipped_open:
        print(f"zoo-dlq: {skipped_open} record(s) in open segment(s) were "
              f"NOT purged — a live server may own them; stop it and "
              f"re-run", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    args = _parse_args(sys.argv[1:] if argv is None else argv)
    try:
        return {"list": cmd_list, "inspect": cmd_inspect,
                "replay": cmd_replay, "purge": cmd_purge}[args.cmd](args)
    except OSError as e:
        print(f"zoo-dlq: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
