"""Invariant linter CLI over the port's tree.

Copy of karpenter_tpu/analysis/__main__.py; the baseline is
karpenter_tpu_torch/analysis/lint_baseline.json.

    python -m karpenter_tpu_torch.analysis                  # all families, baseline-aware
    python -m karpenter_tpu_torch.analysis --rules locks    # one family
    python -m karpenter_tpu_torch.analysis --json           # machine-readable
    python -m karpenter_tpu_torch.analysis --graph          # dump the lock graph
    python -m karpenter_tpu_torch.analysis --graph --family errflow   # seam escape sets
    python -m karpenter_tpu_torch.analysis --write-baseline # (re)seed the allowlist

Exit codes: 0 clean, 1 violations (or a stale baseline entry), 2 usage.
A stale baseline entry -- one that no longer matches any violation --
fails the run: the allowlist shrinks through deliberate edits, never rots.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

from karpenter_tpu_torch.analysis.base import (BASELINE_PATH, apply_baseline,
                                         checkers, iter_modules,
                                         load_baseline, run_suite,
                                         write_baseline)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m karpenter_tpu_torch.analysis",
        description="AST invariant checkers: determinism, lock discipline, "
                    "zero-copy wire, registry drift, torch device "
                    "discipline (torchjit graph/kernel hazards + torchhost "
                    "sync rules), error-path soundness (errflow), and "
                    "resource lifecycle (reslife)")
    ap.add_argument("--rules", action="append", default=None,
                    metavar="FAMILY", help="run only these rule families "
                    f"(choices: {', '.join(checkers())}; repeatable)")
    ap.add_argument("--baseline", default=str(BASELINE_PATH),
                    help="allowlist file (default karpenter_tpu_torch/analysis/"
                         "lint_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report everything, including baselined exceptions")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current violations as the new baseline "
                    "(justifications from matching old entries are kept)")
    ap.add_argument("--json", action="store_true", help="JSON output")
    ap.add_argument("--graph", action="store_true",
                    help="dump a static graph and exit (default: the "
                         "lock-acquisition graph; --family errflow dumps "
                         "the per-seam exception-propagation graph)")
    ap.add_argument("--family", default="locks", metavar="FAMILY",
                    help="which graph --graph dumps: locks (default) or "
                         "errflow")
    ap.add_argument("--seam", default=None, metavar="KEY",
                    help="with --graph --family errflow: restrict the dump "
                         "to seams whose key contains KEY (debugging aid)")
    args = ap.parse_args(argv)

    if args.graph:
        if args.family == "errflow":
            from karpenter_tpu_torch.analysis.checkers import errflow

            mods = iter_modules()
            # ONE analyzer serves both the dump and the exit code: the
            # interprocedural escape-set pass is the expensive part
            an = errflow.ExcAnalyzer(mods)
            payload = errflow.exception_graph(mods, analyzer=an)
            if args.seam:
                payload["seams"] = {k: v for k, v in payload["seams"].items()
                                    if args.seam in k}
            print(json.dumps(payload, indent=2))
            seam_violations = [v for v in errflow.check(mods, analyzer=an)
                               if v.rule.startswith("errflow/seam-")]
            # the exit code honours the baseline (a vetted seam exception
            # still shows in the dump)
            if not args.no_baseline:
                seam_violations = apply_baseline(
                    seam_violations, load_baseline(pathlib.Path(args.baseline)))[0]
            return 0 if not seam_violations else 1
        if args.family != "locks":
            ap.error(f"--graph knows families 'locks' and 'errflow', "
                     f"not {args.family!r}")
        from karpenter_tpu_torch.analysis.checkers.locks import lock_graph

        g = lock_graph(iter_modules())
        payload = {
            "locks": {lid: {"kind": ld.kind, "site": ld.site}
                      for lid, ld in sorted(g.locks.items())},
            "edges": sorted({(e.src, e.dst) for e in g.edges}),
            "cycles": g.cycles(),
        }
        print(json.dumps(payload, indent=2))
        return 0 if not payload["cycles"] else 1

    violations = run_suite(args.rules)

    baseline_path = pathlib.Path(args.baseline)
    entries = [] if args.no_baseline else load_baseline(baseline_path)

    if args.write_baseline:
        old_entries = load_baseline(baseline_path)
        old = {(e["rule"], e["path"], e["line_text"]): e["justification"]
               for e in old_entries}
        # a partial (--rules) rewrite replaces only the selected families'
        # entries; everything out of scope is preserved verbatim
        kept = [e for e in old_entries
                if e["rule"].split("/")[0] not in set(args.rules)] \
            if args.rules else []
        write_baseline(violations, baseline_path, justifications=old,
                       keep=kept)
        print(f"wrote {baseline_path} ({len(violations) + len(kept)} entries)")
        return 0

    fresh, matched, stale = apply_baseline(violations, entries)
    # a partial run must not flag out-of-scope baseline entries as stale
    if args.rules:
        stale = [e for e in stale if e["rule"].split("/")[0] in args.rules]

    if args.json:
        print(json.dumps({
            "violations": [v.__dict__ for v in fresh],
            "baselined": len(matched),
            "stale_baseline": stale,
        }, indent=2))
        return 1 if fresh or stale else 0

    for v in fresh:
        print(v.render())
    for e in stale:
        print(f"{e['path']}: [baseline] stale entry for {e['rule']} "
              f"({e['line_text']!r}) matches nothing; remove it from "
              f"{baseline_path.name}", file=sys.stderr)
    if fresh or stale:
        print(f"\nlint: {len(fresh)} violation(s), {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'} "
              f"({len(matched)} baselined exception(s) suppressed)",
              file=sys.stderr)
        return 1
    print(f"lint: clean ({len(matched)} baselined exception(s), "
          f"{len(entries)} baseline entr{'y' if len(entries) == 1 else 'ies'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
