"""The checkpoint operator CLI — the port of ``scripts/zoo-ckpt``, with
the same subcommands, output and exit codes, over a checkpoint directory
of either package (``utils/checkpoint.py``): which snapshot will a resume
actually load, and can it be trusted?

  python -m analytics_zoo_tpu_torch.utils.ckpt_cli list DIR
                                  inventory: step, state, size, resume meta
                                  (commit markers only — fast)
  python -m analytics_zoo_tpu_torch.utils.ckpt_cli verify DIR
                                  full manifest + CRC32 verification of
                                  every snapshot; READ-ONLY (never
                                  quarantines); exit 2 on any corrupt or
                                  uncommitted snapshot (the newest
                                  uncommitted one may be a live run's save
                                  in flight — the report says so)
  python -m analytics_zoo_tpu_torch.utils.ckpt_cli prune --keep N DIR
                                  delete the oldest committed snapshots
                                  beyond the newest N; quarantined
                                  `ckpt-<n>.corrupt` dirs are never
                                  touched

States: `committed` (manifest present), `legacy` (pre-manifest layout —
restores with a warning, nothing to verify), `uncommitted` (no commit
marker: a save died mid-write; a resume will quarantine + skip it),
`quarantined` (already moved aside by a verified restore), and under
`verify`: `ok` / `corrupt (reason)`.

Exit status: 0 clean, 1 usage/IO error, 2 verification found a snapshot
a resume cannot trust.
"""

import argparse
import os
import shutil
import sys


def _parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="zoo-ckpt",
        description="Inspect, verify, and prune a checkpoint directory.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, help_text in (("list", "inventory (commit markers only)"),
                            ("verify", "full CRC32 verification; exit 2 "
                                       "on any corrupt snapshot")):
        p = sub.add_parser(name, help=help_text)
        p.add_argument("directory", help="checkpoint directory")
    p = sub.add_parser("prune", help="delete oldest committed snapshots "
                                     "beyond --keep N")
    p.add_argument("--keep", type=int, required=True, metavar="N",
                   help="newest committed snapshots to retain (>= 1)")
    p.add_argument("directory", help="checkpoint directory")
    return ap.parse_args(argv)


def _human(n):
    from . import human_bytes
    return human_bytes(n)


def _manager(directory):
    from ..observability.metrics import MetricsRegistry
    from .checkpoint import CheckpointManager
    # a private registry: an operator CLI must not pollute (or depend on)
    # the process-wide one
    return CheckpointManager(directory, keep=0, registry=MetricsRegistry())


def _print_table(entries):
    print(f"{'snapshot':<24} {'step':>8} {'state':<12} {'size':>10}  detail")
    for e in entries:
        detail = e.get("reason") or ""
        print(f"{e['name']:<24} {e['step'] if e['step'] is not None else '-':>8} "
              f"{e['status']:<12} {_human(e['bytes']):>10}  {detail}")


def cmd_list(directory):
    entries = _manager(directory).survey(verify=False)
    if not entries:
        print(f"{directory}: no snapshots")
        return 0
    _print_table(entries)
    return 0


def cmd_verify(directory):
    entries = _manager(directory).survey(verify=True)
    if not entries:
        print(f"{directory}: no snapshots")
        return 0
    _print_table(entries)
    bad = [e for e in entries if e["status"] in ("corrupt", "uncommitted")]
    ok = sum(e["status"] in ("ok", "legacy") for e in entries)
    quarantined = sum(e["status"] == "quarantined" for e in entries)
    print(f"\nverified: {ok} ok, {len(bad)} corrupt/uncommitted, "
          f"{quarantined} quarantined")
    # the NEWEST uncommitted snapshot may be a LIVE writer's save in
    # flight rather than a torn one — still exit 2 (a resume would skip
    # it either way), but say so, or the operator chases a false alarm
    newest = max((e["step"] for e in entries
                  if e["step"] is not None
                  and e["status"] != "quarantined"), default=None)
    for e in bad:
        if e["status"] == "uncommitted" and e["step"] == newest:
            print(f"note: {e['name']} is the newest snapshot — if the "
                  f"training run is still alive this may be a save in "
                  f"flight, not a torn one; re-run to confirm",
                  file=sys.stderr)
    if bad:
        print("zoo-ckpt: verification FAILED: "
              + "; ".join(f"{e['name']}: {e['reason'] or e['status']}"
                          for e in bad), file=sys.stderr)
        return 2
    return 0


def cmd_prune(directory, keep):
    if keep < 1:
        print("zoo-ckpt: --keep must be >= 1 (refusing to delete every "
              "snapshot)", file=sys.stderr)
        return 1
    mgr = _manager(directory)
    steps = mgr.steps()            # committed (manifest or legacy) only
    victims = steps[:-keep] if len(steps) > keep else []
    for s in victims:
        path = os.path.join(directory, f"ckpt-{s}")
        shutil.rmtree(path, ignore_errors=True)
        print(f"pruned ckpt-{s}")
    print(f"kept {min(len(steps), keep)} of {len(steps)} committed "
          f"snapshot(s)")
    return 0


def main(argv=None):
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    if not os.path.isdir(args.directory):
        print(f"zoo-ckpt: {args.directory}: not a directory",
              file=sys.stderr)
        return 1
    if args.cmd == "list":
        return cmd_list(args.directory)
    if args.cmd == "verify":
        return cmd_verify(args.directory)
    return cmd_prune(args.directory, args.keep)


if __name__ == "__main__":
    sys.exit(main())
