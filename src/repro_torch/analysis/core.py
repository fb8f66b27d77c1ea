"""Rule framework for positcheck.

Deliberately small: a ``Rule`` owns an id/severity/fix-hint and a
``check(module)`` generator over a parsed ``ModuleFile``.  Waivers are
per-line comments (``# positcheck: disable=PVU001,PVU005`` or
``disable=all``) and suppress findings anchored on that line or on any
line of the flagged statement's span.  Everything here is stdlib-only so
the analyzer runs in environments without torch (a lint job).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Sequence

WAIVER_RE = re.compile(r"#\s*positcheck:\s*disable=([A-Za-z0-9_,\s*]+)")

SEVERITIES = ("error", "warning")


@dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line."""

    rule_id: str
    severity: str
    path: str  # display path (as given on the command line)
    line: int
    col: int
    message: str
    hint: str = ""

    def format(self, *, show_hint: bool = True) -> str:
        out = f"{self.path}:{self.line}:{self.col}: {self.rule_id} [{self.severity}] {self.message}"
        if show_hint and self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclass
class ModuleFile:
    """A parsed python module plus the waiver map extracted from it."""

    path: Path
    display: str
    source: str
    tree: ast.Module
    # line -> set of waived rule ids ("all" waives everything on the line)
    waivers: dict[int, set[str]] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: Path, display: str | None = None) -> "ModuleFile":
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
        waivers: dict[int, set[str]] = {}
        for lineno, line in enumerate(source.splitlines(), start=1):
            m = WAIVER_RE.search(line)
            if m:
                ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
                waivers[lineno] = {("all" if i in ("all", "*") else i) for i in ids}
        return cls(path=path, display=display or str(path), source=source,
                   tree=tree, waivers=waivers)

    def is_waived(self, rule_id: str, node: ast.AST) -> bool:
        """A finding on ``node`` is waived if any line in the node's span
        (or the node's anchor line) carries a matching waiver comment."""
        lines = {getattr(node, "lineno", 0)}
        end = getattr(node, "end_lineno", None)
        if end is not None:
            lines.update(range(node.lineno, end + 1))
        for ln in lines:
            waived = self.waivers.get(ln)
            if waived and ("all" in waived or rule_id in waived):
                return True
        return False


class Rule:
    """Base class: subclasses set the class attributes and implement
    ``check`` yielding ``(node, message)`` pairs; the runner turns those
    into :class:`Finding`s and applies waivers."""

    id: str = "PVU000"
    severity: str = "error"
    title: str = ""
    hint: str = ""

    def check(self, mod: ModuleFile) -> Iterator[tuple[ast.AST, str]]:
        raise NotImplementedError
        yield  # pragma: no cover

    # -- shared AST helpers -------------------------------------------------

    @staticmethod
    def dotted_name(node: ast.AST) -> str:
        """``lax.dynamic_update_slice`` -> that string; '' if not a plain
        name/attribute chain."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if isinstance(node, ast.Name):
            parts.append(node.id)
            return ".".join(reversed(parts))
        return ""

    @staticmethod
    def call_name(call: ast.Call) -> str:
        return Rule.dotted_name(call.func)

    @staticmethod
    def functions_with_stack(
        tree: ast.Module,
    ) -> Iterator[tuple[ast.FunctionDef | ast.AsyncFunctionDef, tuple[ast.AST, ...]]]:
        """Yield every function definition with its enclosing-scope stack
        (outermost first, excluding the function itself)."""

        def walk(node: ast.AST, stack: tuple[ast.AST, ...]):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield child, stack
                    yield from walk(child, stack + (child,))
                else:
                    yield from walk(child, stack + ((child,) if isinstance(
                        child, ast.ClassDef) else ()))

        yield from walk(tree, ())


def run_module(mod: ModuleFile, rules: Sequence[Rule]) -> tuple[list[Finding], list[Finding]]:
    """Run ``rules`` over one module.  Returns (active, waived) findings."""
    active: list[Finding] = []
    waived: list[Finding] = []
    for rule in rules:
        for node, message in rule.check(mod):
            f = Finding(
                rule_id=rule.id,
                severity=rule.severity,
                path=mod.display,
                line=getattr(node, "lineno", 0),
                col=getattr(node, "col_offset", 0) + 1,
                message=message,
                hint=rule.hint,
            )
            (waived if mod.is_waived(rule.id, node) else active).append(f)
    return active, waived


def iter_python_files(paths: Iterable[str | Path]) -> Iterator[tuple[Path, str]]:
    """Expand files/directories into ``(path, display)`` pairs, sorted."""
    for raw in paths:
        root = Path(raw)
        if root.is_dir():
            for p in sorted(root.rglob("*.py")):
                if "__pycache__" in p.parts:
                    continue
                yield p, str(p)
        elif root.suffix == ".py":
            yield root, str(root)


def run_paths(
    paths: Iterable[str | Path], rules: Sequence[Rule]
) -> tuple[list[Finding], list[Finding], list[str]]:
    """Analyze every python file under ``paths``.

    Returns (active findings, waived findings, unparseable-file errors).
    Findings are sorted by (path, line, rule id).
    """
    active: list[Finding] = []
    waived: list[Finding] = []
    errors: list[str] = []
    for path, display in iter_python_files(paths):
        try:
            mod = ModuleFile.parse(path, display)
        except (SyntaxError, UnicodeDecodeError) as e:
            errors.append(f"{display}: failed to parse: {e}")
            continue
        a, w = run_module(mod, rules)
        active.extend(a)
        waived.extend(w)
    key = lambda f: (f.path, f.line, f.rule_id)  # noqa: E731
    return sorted(active, key=key), sorted(waived, key=key), errors
