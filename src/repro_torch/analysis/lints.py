"""The port's lint registry (``repro/analysis/lints.py`` for the port's
own conventions). Run it as::

    python -m repro_torch.analysis.lints [--json] [rule ...]

Rules:

* ``no-reference-import``: no module under ``src/repro_torch/`` and not
  ``chip_smoke.py`` imports ``jax`` (or ``jaxlib``, ``flax``, ``optax``) or
  the reference package ``repro``: the port stands alone.
* ``no-try-in-kernels``: no ``try`` statement in ``src/repro_torch/
  kernels/``: a kernel that does not build or launch raises, and nothing
  falls back to a plain version around it.
* ``no-torch-compile``: no ``torch.compile`` on the main path (the package
  and ``chip_smoke.py``): every kernel of the port is written by hand.
* ``mesh-axes-literal``: no hard-coded tuple or list of two or more mesh
  axis names (``pod``, ``data``, ``superpod``, ``stage``, ``model``) under
  ``src/repro_torch/`` outside ``launch/mesh.py``, the one home of mesh
  axis-name tuples (the reference's rule, with the port's mesh file as
  its home).

Suppression: append ``# lint: disable=<rule>`` (comma-separated for
several rules) to the flagged line or the line above it.

This module imports the standard library only: importing it (and running
the CLI) loads no torch. The reference's registry (``repro.analysis.lints``,
``scripts/lint.py``) stays as it is and scans ``src/`` as a whole, this
package included.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import re
import sys
from typing import Callable, Dict, Iterator, List, Optional, Sequence

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([\w\-, ]+)")
_FOREIGN = frozenset({"jax", "jaxlib", "flax", "optax", "repro"})


@dataclasses.dataclass(frozen=True)
class LintViolation:
    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.message}"

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class LintRule:
    name: str
    description: str
    check: Callable[[str], List[LintViolation]]  # repo root -> violations


RULES: Dict[str, LintRule] = {}


def rule(name: str, description: str):
    def register(fn):
        RULES[name] = LintRule(name=name, description=description, check=fn)
        return fn

    return register


def repo_root() -> str:
    here = os.path.abspath(__file__)
    for _ in range(4):  # analysis -> repro_torch -> src -> repo
        here = os.path.dirname(here)
    return here


def _port_files(root: str, sub: str = "") -> List[str]:
    base = os.path.join(root, "src", "repro_torch", sub)
    out = []
    for dirpath, _dirnames, filenames in os.walk(base):
        out.extend(os.path.join(dirpath, n) for n in filenames
                   if n.endswith(".py"))
    return sorted(out)


def _main_path(root: str) -> List[str]:
    smoke = os.path.join(root, "chip_smoke.py")
    return _port_files(root) + ([smoke] if os.path.exists(smoke) else [])


def _rel(path: str, root: str) -> str:
    return os.path.relpath(path, root).replace(os.sep, "/")


def _parse(path: str) -> ast.AST:
    with open(path) as fh:
        return ast.parse(fh.read(), filename=path)


def _suppressed(lines: List[str], lineno: int, rule_name: str) -> bool:
    """``# lint: disable=<rule>`` on the flagged line or the line above."""
    for ln in (lineno - 1, lineno - 2):
        if 0 <= ln < len(lines):
            m = _SUPPRESS_RE.search(lines[ln])
            if m and rule_name in [p.strip() for p in m.group(1).split(",")]:
                return True
    return False


def run_lints(root: Optional[str] = None,
              rules: Optional[Sequence[str]] = None) -> List[LintViolation]:
    """Run the registry (all rules, or a subset) and drop suppressed lines."""
    root = root or repo_root()
    names = list(rules) if rules is not None else sorted(RULES)
    unknown = [n for n in names if n not in RULES]
    if unknown:
        raise KeyError(f"unknown lint rule(s): {unknown}; have {sorted(RULES)}")
    out: List[LintViolation] = []
    lines: Dict[str, List[str]] = {}
    for name in names:
        for v in RULES[name].check(root):
            path = os.path.join(root, v.path)
            if path not in lines:
                with open(path) as fh:
                    lines[path] = fh.read().splitlines()
            if not _suppressed(lines[path], v.line, v.rule):
                out.append(v)
    return out


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _imports(tree: ast.AST) -> Iterator[tuple]:
    """(line, root package) of every absolute import."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and node.module):
            yield node.lineno, node.module.split(".")[0]


@rule("no-reference-import",
      "no jax/jaxlib/flax/optax or reference-package (repro) import under "
      "src/repro_torch/ or in chip_smoke.py")
def _no_reference_import(root: str) -> List[LintViolation]:
    out = []
    for path in _main_path(root):
        for line, pkg in _imports(_parse(path)):
            if pkg in _FOREIGN:
                out.append(LintViolation(
                    "no-reference-import", _rel(path, root), line,
                    f"imports {pkg}: the port imports torch and numpy only, "
                    "never JAX or the reference package"))
    return out


@rule("no-try-in-kernels",
      "no try statement in src/repro_torch/kernels/: a kernel build or "
      "launch that fails raises")
def _no_try_in_kernels(root: str) -> List[LintViolation]:
    out = []
    for path in _port_files(root, "kernels"):
        for node in ast.walk(_parse(path)):
            if isinstance(node, ast.Try) or type(node).__name__ == "TryStar":
                out.append(LintViolation(
                    "no-try-in-kernels", _rel(path, root), node.lineno,
                    "try statement in the kernels package: a kernel that "
                    "does not build or launch must raise, not fall back"))
    return out


@rule("no-torch-compile",
      "no torch.compile under src/repro_torch/ or in chip_smoke.py: the "
      "port's kernels are written by hand")
def _no_torch_compile(root: str) -> List[LintViolation]:
    out = []
    for path in _main_path(root):
        for node in ast.walk(_parse(path)):
            if (isinstance(node, ast.Attribute) and node.attr == "compile"
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "torch"):
                out.append(LintViolation(
                    "no-torch-compile", _rel(path, root), node.lineno,
                    "torch.compile on the main path: a kernel of the port "
                    "is written by hand, never generated"))
    return out


# A frozenset (an ast.Set, never a Tuple), so the rule cannot flag itself.
_MESH_AXIS_NAMES = frozenset({"pod", "data", "superpod", "stage", "model"})
_MESH_AXES_HOME = "src/repro_torch/launch/mesh.py"


@rule("mesh-axes-literal",
      "no hard-coded mesh axis-name tuples under src/repro_torch/ outside "
      "launch/mesh.py: import REPLICA_AXES or use the mesh helpers")
def _mesh_axes_literal(root: str) -> List[LintViolation]:
    out = []
    for path in _port_files(root):
        rel = _rel(path, root)
        if rel == _MESH_AXES_HOME:
            continue
        for node in ast.walk(_parse(path)):
            if (isinstance(node, (ast.Tuple, ast.List))
                    and len(node.elts) >= 2
                    and all(isinstance(e, ast.Constant)
                            and isinstance(e.value, str)
                            and e.value in _MESH_AXIS_NAMES
                            for e in node.elts)):
                names = ", ".join(repr(e.value) for e in node.elts)
                out.append(LintViolation(
                    "mesh-axes-literal", rel, node.lineno,
                    f"hard-coded mesh axes ({names}): import them from "
                    "repro_torch.launch.mesh (REPLICA_AXES, level_axes_for)"))
    return out


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lints",
        description="Run the port's lint rules over the repository.")
    parser.add_argument("rules", nargs="*", help="rules to run (default: all)")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON object instead of lines")
    args = parser.parse_args(argv)
    violations = run_lints(rules=args.rules or None)
    if args.json:
        print(json.dumps({
            "ok": not violations,
            "rules": sorted(args.rules or RULES),
            "violations": [v.to_dict() for v in violations],
        }, indent=2))
    else:
        for v in violations:
            print(v.format())
        print(f"port lint: {'OK' if not violations else 'FAILED'} "
              f"({len(violations)} violation(s))")
    return 0 if not violations else 1


if __name__ == "__main__":
    sys.exit(main())
