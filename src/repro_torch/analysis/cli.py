"""positcheck CLI for the port.

Usage::

    PYTHONPATH=src python -m repro_torch.analysis [paths ...]

Defaults to scanning ``src/repro_torch``.  Exits non-zero on any
non-waived finding (regardless of severity).  ``--list-rules`` documents
the rule set; ``--show-waived`` prints suppressed findings for
auditability.
"""
from __future__ import annotations

import argparse
import sys

from .core import run_paths
from .rules import ALL_RULES


def list_rules() -> str:
    lines = ["positcheck rules (repro_torch):"]
    for r in ALL_RULES:
        lines.append(f"  {r.id} [{r.severity:7s}] {r.title}")
        lines.append(f"      fix: {r.hint}")
    lines.append(
        "\nwaive a finding with '# positcheck: disable=<ID>[,<ID>...]' "
        "(or disable=all) on the flagged line, plus a comment saying why "
        "the invariant holds there."
    )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="positcheck: static analyzer for the port's serving-stack invariants",
    )
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to scan (default: src/repro_torch)")
    parser.add_argument("--list-rules", action="store_true",
                        help="describe the rule set and exit")
    parser.add_argument("--show-waived", action="store_true",
                        help="also print findings suppressed by waivers")
    parser.add_argument("--no-hints", action="store_true",
                        help="omit fix hints from the report")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(list_rules())
        return 0

    active, waived, errors = run_paths(args.paths, ALL_RULES)

    for err in errors:
        print(f"positcheck: ERROR {err}", file=sys.stderr)
    for f in active:
        print(f.format(show_hint=not args.no_hints))
    if args.show_waived:
        for f in waived:
            print(f"[waived] {f.format(show_hint=False)}")

    n_err = sum(1 for f in active if f.severity == "error")
    n_warn = len(active) - n_err
    print(
        f"positcheck: {len(active)} finding(s) "
        f"({n_err} error, {n_warn} warning, {len(waived)} waived)"
    )
    return 1 if (active or errors) else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
