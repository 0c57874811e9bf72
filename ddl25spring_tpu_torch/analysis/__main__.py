"""The port's lint and signature gate: the counterpart of the source half of
``tools/graft_lint.py`` (:221-262) and of its ``--strategy`` pass.

    python -m ddl25spring_tpu_torch.analysis                  # source rules
    python -m ddl25spring_tpu_torch.analysis --check --host-safety
    python -m ddl25spring_tpu_torch.analysis --strategy train --device cpu --check
    python -m ddl25spring_tpu_torch.analysis --strategy dp,zero3 --format json

- the source pass (S101, S103; skip with ``--no-src``) over the port's
  package (:mod:`~ddl25spring_tpu_torch.analysis.source_lint`);
- ``--host-safety``: S201-S205 over the modules that own threads, handlers
  and host mirrors (:mod:`~ddl25spring_tpu_torch.analysis.host_safety`);
- ``--strategy NAME[,NAME...]`` or ``train`` (all 16 training strategies):
  one world of ranks spawned on ``--device`` (the card unless ``cpu`` is
  asked for) runs one step of each strategy's ``describe()`` on its default
  mesh and judges its collective signature
  (:mod:`~ddl25spring_tpu_torch.obs.comm_analytics`); the report lines are
  rank 0's, the verdict every rank's.

Every finding is resolved against the waiver file (``--waivers``, default
``analysis/waivers.toml``); a waiver without a reason is finding W000.
``--check`` exits 1 on any unwaived finding or violated signature.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ddl25spring_tpu_torch.analysis import host_safety, source_lint
from ddl25spring_tpu_torch.analysis.rules import summarize
from ddl25spring_tpu_torch.analysis.waivers import apply_waivers, check_waivers, load_waivers

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fmt_finding(f: dict) -> str:
    loc = " ".join(x for x in (f.get("strategy"), f.get("op"), f.get("source")) if x)
    line = f"  {f['rule']} [{f['severity']:<5}] {loc}\n      {f['message']}"
    if f.get("fix_hint"):
        line += f"\n      fix: {f['fix_hint']}"
    if f.get("waived"):
        line += f"\n      WAIVED: {f['waived_reason']}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ddl25spring_tpu_torch.analysis",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--strategy", default=None,
                    help="comma-separated training strategies, or 'train' for all of them")
    ap.add_argument("--device", default="cuda", help="the strategies' device: cuda or cpu")
    ap.add_argument("--format", choices=("table", "json"), default="table")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on any unwaived finding or violated signature")
    ap.add_argument("--host-safety", action="store_true",
                    help="run S201-S205 over the modules that own threads, handlers, mirrors")
    ap.add_argument("--no-src", action="store_true", help="skip the source pass")
    ap.add_argument("--waivers", default=None, metavar="TOML",
                    help="waiver file (default: the port's analysis/waivers.toml)")
    ap.add_argument("--root", default=_ROOT, help="the root the passes read")
    args = ap.parse_args(argv)

    bad_waivers = check_waivers(args.waivers)
    waivers = [] if bad_waivers else load_waivers(args.waivers)
    src = None if args.no_src else apply_waivers(source_lint.lint_repo(args.root), waivers)
    src = None if src is None else bad_waivers + src
    inv = host = None
    if args.host_safety:
        inv, host = host_safety.lint_repo(args.root)
        host = apply_waivers(host, waivers)

    reports: dict = {}
    if args.strategy:
        from ddl25spring_tpu_torch.obs import comm_analytics

        want = args.strategy.strip()
        names = (list(comm_analytics.STRATEGIES) if want == "train"
                 else [s.strip() for s in want.split(",") if s.strip()])
        for name in names:
            comm_analytics.mesh_sizes(name)  # unknown or serving names raise here
        per_rank = comm_analytics.run_in_world(names, args.device)
        for name in names:
            reports[name] = [r[name] for r in per_rank if r[name] is not None]

    if args.format == "json":
        doc = {"record": "torch_lint",
               "source": [f.to_dict() for f in src or []],
               "strategies": reports}
        if host is not None:
            doc["host_safety"] = {"inventory": inv.summary(),
                                  "findings": [f.to_dict() for f in host]}
        print(json.dumps(doc, indent=1, default=str))
    else:
        from ddl25spring_tpu_torch.obs import comm_analytics

        if src is not None:
            s = summarize(src)
            print(f"source lint: {s['findings']} finding(s), {s['unwaived']} unwaived")
            for f in src:
                print(_fmt_finding(f.to_dict()))
        if host is not None:
            s, i = summarize(host), inv.summary()
            print(f"host-safety: {s['findings']} finding(s), {s['unwaived']} unwaived "
                  f"[{i['files']} files, {i['functions']} functions, {len(i['locks'])} "
                  f"lock(s), entries {i['entry_points']}, {i['mirror_contracts']} mirror "
                  "contract(s)]")
            for f in host:
                print(_fmt_finding(f.to_dict()))
        for name, reps in reports.items():
            print(comm_analytics.format_report(reps[0]))
            for r in reps[1:]:
                if r["signature_violations"]:
                    print("  " + comm_analytics.format_report(r))

    if not args.check:
        return 0
    bad = [f"{f.rule} {f.source} {f.op}" for f in (src or []) + (host or []) if not f.waived]
    bad += [f"{name} rank {r['rank']}: {v}" for name, reps in reports.items()
            for r in reps for v in r["signature_violations"]]
    for b in bad:
        print(f"CHECK FAIL {b}", file=sys.stderr)
    if bad:
        print(f"lint: {len(bad)} unwaived finding(s) or violation(s)", file=sys.stderr)
        return 1
    print("lint OK: " + ", ".join(
        x for x in ("source pass clean" if src is not None else "source pass skipped",
                    "host-safety pass clean" if host is not None else "",
                    f"{len(reports)} signature(s) held" if reports else "") if x)
        + " (waivers applied)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
