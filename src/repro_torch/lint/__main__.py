"""CLI: ``python -m repro_torch.lint [paths] [--json] [--select pass,...]``.

Exit status: 0 on a clean tree, 1 on any finding, 2 on usage errors.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.lint import (DEFAULT_PATHS, available_passes,
                               findings_to_json, rule_catalogue, run_lint)
from repro_torch.lint import wire_checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="fedlint for the port: host-sync/autograd.Function/"
                    "mesh/CUDA-source/wire static analysis (see the "
                    "repro_torch.lint docstring for the rule catalogue)")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: "
                         f"{' '.join(DEFAULT_PATHS)})")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--select", default=None, metavar="PASS[,PASS...]",
                    help=f"run only these passes (available: "
                         f"{', '.join(available_passes())})")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the pass/rule catalogue and exit")
    ap.add_argument("--update-wire-manifest", action="store_true",
                    help="re-pin encode-body hashes in wire_manifest.json "
                         "for the given paths, then exit")
    args = ap.parse_args(argv)
    paths = args.paths or list(DEFAULT_PATHS)

    if args.list_rules:
        for pass_name, rules in rule_catalogue().items():
            print(pass_name)
            for rule, desc in sorted(rules.items()):
                print(f"  {rule}: {desc}")
        return 0

    if args.update_wire_manifest:
        manifest = wire_checks.update_manifest(paths)
        print(f"pinned {len(manifest)} encoder(s) in "
              f"{wire_checks.MANIFEST_PATH}")
        return 0

    select = [s.strip() for s in args.select.split(",") if s.strip()] \
        if args.select else None
    try:
        findings = run_lint(paths, select)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.json:
        print(findings_to_json(findings))
    else:
        for f in findings:
            print(f.format())
        print(f"{len(findings)} finding(s) from "
              f"{len(select or available_passes())} pass(es)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
