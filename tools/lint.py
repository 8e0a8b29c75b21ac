#!/usr/bin/env python
"""Minimal AST linter (the environment ships no ruff/flake8; this is the
`make lint` backend so CI lint actually executes — reference parity row:
clippy in .github/workflows/ci.yaml).

Checks:
  F401 unused import            E722 bare except
  B006 mutable default arg      F541 f-string without placeholders
  E501 line > 100 chars         W291 trailing whitespace
  SYNTAX compile errors
"""
from __future__ import annotations

import ast
import sys
from pathlib import Path

MAX_LINE = 100


def _used_names(tree: ast.AST) -> set[str]:
    used = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            used.add(node.id)
        elif isinstance(node, ast.Attribute):
            n = node
            while isinstance(n, ast.Attribute):
                n = n.value
            if isinstance(n, ast.Name):
                used.add(n.id)
    return used


def lint_file(path: Path) -> list[str]:
    src = path.read_text()
    problems = []
    try:
        tree = ast.parse(src, filename=str(path))
    except SyntaxError as e:
        return [f"{path}:{e.lineno}: SYNTAX {e.msg}"]

    used = _used_names(tree)
    # names re-exported via __all__ count as used
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and
                any(isinstance(t, ast.Name) and t.id == "__all__"
                    for t in node.targets) and
                isinstance(node.value, (ast.List, ast.Tuple))):
            for elt in node.value.elts:
                if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                    used.add(elt.value)

    # format specs of f-string fields are themselves JoinedStr nodes —
    # exclude them (and anything nested in them) from the F541 check
    spec_ids = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.FormattedValue) and node.format_spec:
            for sub in ast.walk(node.format_spec):
                spec_ids.add(id(sub))

    is_init = path.name == "__init__.py"
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)) and not is_init:
            if getattr(node, "module", None) == "__future__":
                continue
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                if name != "*" and name not in used:
                    problems.append(
                        f"{path}:{node.lineno}: F401 unused import '{name}'")
        elif isinstance(node, ast.ExceptHandler) and node.type is None:
            problems.append(f"{path}:{node.lineno}: E722 bare except")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in node.args.defaults + node.args.kw_defaults:
                if isinstance(default, (ast.List, ast.Dict, ast.Set)):
                    problems.append(
                        f"{path}:{default.lineno}: B006 mutable default arg "
                        f"in '{node.name}'")
        elif isinstance(node, ast.JoinedStr) and id(node) not in spec_ids:
            if not any(isinstance(v, ast.FormattedValue) for v in node.values):
                problems.append(
                    f"{path}:{node.lineno}: F541 f-string without "
                    f"placeholders")

    for i, line in enumerate(src.splitlines(), 1):
        if len(line) > MAX_LINE:
            problems.append(f"{path}:{i}: E501 line too long ({len(line)})")
        if line != line.rstrip():
            problems.append(f"{path}:{i}: W291 trailing whitespace")
    return problems


def main(argv):
    targets = argv or ["solstrale", "tests", "tools", "bench.py",
                       "__graft_entry__.py"]
    files = []
    for t in targets:
        p = Path(t)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    problems = []
    for f in files:
        problems.extend(lint_file(f))
    for p in problems:
        print(p)
    print(f"lint: {len(files)} files, {len(problems)} problems")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
