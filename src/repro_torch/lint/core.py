"""fedlint framework: findings, suppressions, the pass registry, the runner.

The framework mirrors the repo's compressor/executor registry idiom
(``core/compressors.py`` / ``federated/executor.py``): passes register
factories by name, selection is by name (``--select``), and unknown names
fail loudly with the registered set in the message.

Two kinds of file are loaded: Python sources (parsed to an AST) and CUDA
sources (``.cu`` / ``.cuh``, kept as text, ``Module.tree`` is None). A
pass sees the kinds it declares in ``LintPass.reads`` (Python only by
default); the CUDA checks read ``("cuda",)``.

A `LintPass` sees every file twice:

  1. ``collect(module, ctx)`` — gather cross-file facts (e.g. every mesh
     axis declared anywhere) into ``ctx``;
  2. ``check(module, ctx)``  — emit `Finding`s against one module, with the
     whole-tree facts available.

Suppressions are source comments, checked per finding line:

  * ``# fedlint: disable=<rule>[,<rule>...]`` — suppress on that line;
  * ``# fedlint: disable=all``                — suppress every rule there;
  * ``# fedlint: disable-file=<rule>[,...]``  — suppress for the whole file;

and the same with ``//`` in place of ``#`` in a CUDA source.

Suppressing a rule is a reviewed decision: the comment lands in the diff,
whereas an un-suppressed finding fails the gate (``tests/test_torch_lint.py``
and ``chip_smoke.py``'s lint phase run ``python -m repro_torch.lint`` over
the port and refuse on any finding).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

# JSON schema version for --json output (tests pin the layout)
JSON_SCHEMA_VERSION = 1

_SUPPRESS_RE = re.compile(
    r"#\s*fedlint:\s*(?P<scope>disable|disable-file)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s-]+)")
_CUDA_SUPPRESS_RE = re.compile(
    r"//\s*fedlint:\s*(?P<scope>disable|disable-file)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s-]+)")

PYTHON_SUFFIXES = (".py",)
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One lint result: where, which rule, and why it matters."""
    path: str          # file, relative to the lint invocation
    line: int          # 1-indexed source line
    rule: str          # stable rule id (kebab-case; suppression key)
    message: str       # human explanation with the concrete evidence
    severity: str = "error"
    pass_name: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity} "
                f"[{self.rule}] {self.message}")

    def to_json(self) -> Dict[str, object]:
        return {"path": self.path, "line": self.line, "rule": self.rule,
                "severity": self.severity, "pass": self.pass_name,
                "message": self.message}


class Module:
    """One source file plus its suppression table: a Python file parsed to
    an AST, or a CUDA source kept as text (``tree`` None)."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.kind = "cuda" if path.endswith(CUDA_SUFFIXES) else "python"
        self.tree = ast.parse(source, filename=path) \
            if self.kind == "python" else None
        pattern = _CUDA_SUPPRESS_RE if self.kind == "cuda" else _SUPPRESS_RE
        self.line_suppressions: Dict[int, set] = {}
        self.file_suppressions: set = set()
        for lineno, line in enumerate(self.lines, start=1):
            m = pattern.search(line)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            if m.group("scope") == "disable-file":
                self.file_suppressions |= rules
            else:
                self.line_suppressions.setdefault(lineno, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if self.file_suppressions & {rule, "all"}:
            return True
        at = self.line_suppressions.get(line, set())
        return bool(at & {rule, "all"})


class LintContext:
    """Cross-file facts accumulated by the collect phase.

    Passes namespace their facts by attribute (``ctx.mesh_axes`` etc.) —
    a plain attribute bag keeps pass modules decoupled from each other.
    """

    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)


class LintPass:
    """Base pass: subclass, set ``name``/``rules``, implement ``check``."""
    name: str = "base"
    # rule id -> one-line description (the --list-rules catalogue)
    rules: Dict[str, str] = {}
    # the kinds of Module the pass is handed ("python", "cuda")
    reads: Tuple[str, ...] = ("python",)

    def collect(self, module: Module, ctx: LintContext) -> None:
        """Phase 1: gather cross-file facts (default: nothing)."""

    def check(self, module: Module, ctx: LintContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, module: Module, node, rule: str, message: str,
                severity: str = "error") -> Finding:
        if rule not in self.rules:
            raise ValueError(f"pass {self.name!r} emitted unregistered rule "
                             f"{rule!r}; known: {sorted(self.rules)}")
        line = getattr(node, "lineno", node if isinstance(node, int) else 1)
        return Finding(path=module.path, line=int(line), rule=rule,
                       message=message, severity=severity,
                       pass_name=self.name)


# ---------------------------------------------------------------------------
# registry (the compressor/executor idiom)
# ---------------------------------------------------------------------------

_PASSES: Dict[str, Callable[[], LintPass]] = {}


def register_pass(name: str, factory: Callable[[], LintPass]) -> None:
    """Register (or replace) a named lint pass factory."""
    _PASSES[name] = factory


def available_passes() -> Tuple[str, ...]:
    return tuple(sorted(_PASSES))


def make_passes(select: Optional[Sequence[str]] = None) -> List[LintPass]:
    names = list(select) if select else list(available_passes())
    unknown = [n for n in names if n not in _PASSES]
    if unknown:
        raise ValueError(f"unknown lint pass(es) {unknown}; registered: "
                         f"{available_passes()}")
    return [_PASSES[n]() for n in names]


def rule_catalogue() -> Dict[str, Dict[str, str]]:
    """pass name -> {rule id -> description} for every registered pass."""
    return {name: dict(_PASSES[name]().rules) for name in available_passes()}


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

def iter_python_files(paths: Sequence[str]) -> List[Path]:
    """The Python and CUDA sources under ``paths`` (files or directories),
    in a stable order."""
    suffixes = PYTHON_SUFFIXES + CUDA_SUFFIXES
    files: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            files.extend(sorted(f for f in path.rglob("*")
                                if f.suffix in suffixes and f.is_file()))
        elif path.suffix in suffixes:
            files.append(path)
        elif not path.exists():
            raise FileNotFoundError(f"lint target {p!r} does not exist")
    # stable order, no duplicates
    seen, unique = set(), []
    for f in files:
        if f not in seen:
            seen.add(f)
            unique.append(f)
    return unique


def load_modules(paths: Sequence[str]) -> List[Module]:
    modules = []
    for f in iter_python_files(paths):
        source = f.read_text(encoding="utf-8")
        modules.append(Module(str(f), source))
    return modules


def run_passes(modules: Sequence[Module],
               passes: Sequence[LintPass]) -> List[Finding]:
    ctx = LintContext(modules)
    for p in passes:
        for m in modules:
            if m.kind in p.reads:
                p.collect(m, ctx)
    findings: set = set()
    for p in passes:
        for m in modules:
            if m.kind not in p.reads:
                continue
            for f in p.check(m, ctx):
                if not m.suppressed(f.rule, f.line):
                    findings.add(f)
    return sorted(findings)


def run_lint(paths: Sequence[str],
             select: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint ``paths`` (files or directories) with the selected passes."""
    return run_passes(load_modules(paths), make_passes(select))


def findings_to_json(findings: Sequence[Finding]) -> str:
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    doc = {
        "schema_version": JSON_SCHEMA_VERSION,
        "findings": [f.to_json() for f in findings],
        "counts": dict(sorted(counts.items())),
        "total": len(findings),
    }
    return json.dumps(doc, indent=2, sort_keys=False)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    return dotted_name(call.func)


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def str_constants(node: ast.AST) -> List[Tuple[str, int]]:
    """Every string literal under ``node`` with its line number."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.append((n.value, n.lineno))
    return out


def iter_calls(tree: ast.AST) -> Iterable[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def is_test_path(path: str) -> bool:
    parts = Path(path).parts
    return any(p in ("tests", "test") for p in parts) \
        or Path(path).name.startswith("test_")
