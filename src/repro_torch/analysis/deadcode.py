"""Dead-import analysis, RPA901 (info) (counterpart of
`repro.analysis.deadcode`).

Walks the static import graph of the port's package (`ast` only, nothing is
imported or executed) from the CNN serving spine's entry points and reports
every module no import path reaches as an info diagnostic, so the surface
the spine does not run (the LM stack, for one) stays visible.

Imports are collected at ANY depth (the repo idiom is function-local lazy
imports), so a module only imported inside a function still counts as
reachable. Importing a submodule marks every ancestor package reachable
(their __init__ executes on import).
"""
from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.diagnostics import DiagnosticSink

#: the CNN spine: every module a lint or serving run can enter through.
DEFAULT_ROOTS = ("repro_torch.launch.serve_cnn", "repro_torch.analysis.cli")
PACKAGE = "repro_torch"


def _module_name(path: Path, src: Path) -> str:
    rel = path.relative_to(src).with_suffix("")
    parts = list(rel.parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _imports_of(path: Path, mod: str, known: set) -> set:
    """Module names (within `known`) this file can import, any depth."""
    tree = ast.parse(path.read_text(), filename=str(path))
    pkg_parts = mod.split(".")
    if path.name != "__init__.py":
        pkg_parts = pkg_parts[:-1]
    out = set()

    def add(name: str) -> None:
        # importing a.b.c executes a and a.b too
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            cand = ".".join(parts[:i])
            if cand in known:
                out.add(cand)

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                add(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg_parts[: len(pkg_parts) - node.level + 1]
                prefix = ".".join(base + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
            if prefix:
                add(prefix)
            for alias in node.names:
                if prefix and alias.name != "*":
                    add(f"{prefix}.{alias.name}")
    return out


def import_graph(src: Path, package: str = PACKAGE) -> tuple:
    """({module -> set of imported modules}, {module -> file}) over
    src/<package>/**/*.py (`src` holds the JAX package too, which the port's
    spine never imports)."""
    files = {_module_name(p, src): p for p in sorted((src / package).rglob("*.py"))}
    known = set(files)
    return {m: _imports_of(p, m, known) for m, p in files.items()}, files


def dead_modules(src: Path, roots=DEFAULT_ROOTS) -> tuple:
    """(module names unreachable from `roots`, {module -> file})."""
    graph, files = import_graph(src)
    seen: set = set()
    frontier = [r for r in roots if r in graph]
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        # entering a module executes every ancestor package __init__
        parts = m.split(".")
        for i in range(1, len(parts)):
            pkg = ".".join(parts[:i])
            if pkg in graph and pkg not in seen:
                frontier.append(pkg)
        frontier.extend(graph[m] - seen)
    return sorted(m for m in graph if m not in seen), files


def check_dead_imports(src, sink: DiagnosticSink,
                       roots=DEFAULT_ROOTS) -> None:
    """Emit one RPA901 info diagnostic per unreachable module."""
    src = Path(src)
    dead, files = dead_modules(src, roots)
    for m in dead:
        sink.add("RPA901",
                 f"{m} ({files[m].relative_to(src)}) is unreachable from "
                 f"the CNN spine ({', '.join(roots)})",
                 kind="repo",
                 hint="not on the CNN serving path: reached by another "
                      "entry point, or a candidate for removal")
