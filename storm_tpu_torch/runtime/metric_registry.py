"""Generator of the port's metric-name registry (``metric_names.py``).

Every ``.counter`` / ``.gauge`` / ``.histogram`` call in the package whose
name argument is a literal adds that name, and so does a call through a
local alias of one (``g = metrics.gauge``); an f-string name adds a
wildcard pattern (its literal chunks joined by ``*``). The registry is
what :func:`storm_tpu_torch.runtime.metrics._check_name` reads. Regenerate
it after adding or renaming a metric::

    python -m storm_tpu_torch.runtime.metric_registry
"""

from __future__ import annotations

import ast
import os
from typing import Iterator, Set, Tuple

PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET = os.path.join(PACKAGE, "runtime", "metric_names.py")
_KINDS = ("counter", "gauge", "histogram")

_HEADER = '''"""The port's metric-name registry: GENERATED, do not edit by hand.

Regenerate after adding or renaming a metric::

    python -m storm_tpu_torch.runtime.metric_registry

Literal names of every ``counter``/``gauge``/``histogram`` call in
``storm_tpu_torch/`` land in ``METRIC_NAMES``; f-string names give a
wildcard pattern in ``METRIC_PATTERNS``. ``runtime/metrics.py`` warns once
for a name that matches neither.
"""

from __future__ import annotations

import fnmatch
'''


def _pattern_of(js: ast.JoinedStr) -> str:
    parts = [v.value if isinstance(v, ast.Constant) and isinstance(v.value, str) else "*"
             for v in js.values]
    pat = "".join(parts)
    while "**" in pat:
        pat = pat.replace("**", "*")
    return pat


def _sources(root: str) -> Iterator[str]:
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            if f.endswith(".py") and path != TARGET:
                yield path


def collect(root: str = PACKAGE) -> Tuple[Set[str], Set[str]]:
    """(literal names, f-string patterns) of every metric call site."""
    names: Set[str] = set()
    patterns: Set[str] = set()
    for path in _sources(root):
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read(), path)
        aliases = {t.id for node in ast.walk(tree) if isinstance(node, ast.Assign)
                   and isinstance(node.value, ast.Attribute) and node.value.attr in _KINDS
                   for t in node.targets if isinstance(t, ast.Name)}
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not (
                    isinstance(node.func, ast.Attribute) and node.func.attr in _KINDS
                    or isinstance(node.func, ast.Name) and node.func.id in aliases):
                continue
            arg = node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "name"), None)
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value)
            elif isinstance(arg, ast.JoinedStr):
                patterns.add(_pattern_of(arg))
    return names, patterns


def render(names: Set[str], patterns: Set[str]) -> str:
    lines = [_HEADER, "METRIC_NAMES = frozenset({"]
    lines += [f"    {n!r}," for n in sorted(names)]
    lines += ["})", "", "METRIC_PATTERNS = ("]
    lines += [f"    {p!r}," for p in sorted(patterns)]
    lines += [")", "", "", "def is_known(name: str) -> bool:",
              "    if name in METRIC_NAMES:", "        return True",
              "    return any(fnmatch.fnmatchcase(name, p) for p in METRIC_PATTERNS)", ""]
    return "\n".join(lines)


def main() -> None:
    with open(TARGET, "w", encoding="utf-8") as fh:
        fh.write(render(*collect()))


if __name__ == "__main__":
    main()
