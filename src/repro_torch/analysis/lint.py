"""Repo-specific AST lint of the port (port of ``repro.analysis.lint``).

Rules (ids are stable; suppress a line with ``# analysis: ignore[rule]``
on the flagged line or the line above, with a justification comment):

* ``lint-mutable-default`` — mutable default values: ``x=[]`` / ``x={}``
  / ``cfg=ServeConfig()`` in signatures, and bare mutable class
  attributes in ``@dataclass`` bodies: one shared instance leaks state
  across calls.  JAX's rule, unchanged.
* ``lint-kernel-launch-outside-kernels`` — ``runtime.load(...)``,
  ``ctypes.CDLL(...)`` or a wrapper's ``_lib()`` / ``_banked_lib()``
  outside ``src/repro_torch/kernels/``: a raw launch bypasses the
  wrappers' checks, the CPU switch and the launch counters (JAX's
  ``lint-pallas-call-outside-kernels``).
* ``lint-host-sync-in-hot-path`` — ``.item()``, ``.tolist()``,
  ``.numpy()``, ``.cpu()``, ``torch.cuda.synchronize`` or a blocking
  ``.to(<device>)`` (no ``non_blocking=True``) in a hot function: the
  roots in :data:`HOT_ROOTS` (what chip_smoke runs with synchronizing
  CUDA calls made errors) and every port function they reach, read from
  the call graph.  A sync there stalls the launch loop on the device
  (JAX's ``lint-tracer-cast`` and ``lint-host-call-in-jit`` guarded the
  jitted bodies).
* ``lint-global-rng`` — ``torch.rand*`` / ``randn*`` / ``randint*``,
  ``normal_`` or ``bernoulli`` without ``generator=``: the global
  generator makes a run depend on every earlier draw (the random half of
  JAX's ``lint-host-call-in-jit``).
* ``lint-reference-import`` — ``import jax``, ``jaxlib`` or ``repro``:
  the port runs without the JAX package.

JAX's ``lint-missing-donate`` has no counterpart: the port updates its
membrane state in place (the scheduler passes ``out=`` tiles), so there
is no input buffer to donate.

By default the rules lint ``src/repro_torch`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable, Optional

from .report import Report

IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore\[([a-zA-Z0-9,\- ]+)\]")

#: (path suffix, qualified name) of the hot roots: the forward's chunk
#: step and the scheduler's batched runner under it, the sharded
#: forward, the engine's chunk step and batch inference, the LM
#: decode loop (the decoders' and whisper's decode step, and
#: ``Engine.generate``), and the LM training loop (its step, the loss
#: under it, and ``run``, which reads the loss at log steps only)
HOT_ROOTS: frozenset[tuple[str, str]] = frozenset({
    ("core/csnn.py", "snn_step_chunk"),
    ("core/csnn.py", "snn_apply_sharded"),
    ("core/scheduler.py", "run_conv_layer_batched_chunk"),
    ("serve/csnn_engine.py", "CSNNEngine._step"),
    ("serve/csnn_engine.py", "CSNNEngine._infer"),
    ("models/transformer.py", "decode_step"),
    ("models/encdec.py", "decode_step"),
    ("serve/engine.py", "Engine.generate"),
    ("models/transformer.py", "loss_fn"),
    ("models/encdec.py", "loss_fn"),
    ("train/loop.py", "make_train_step"),
    ("train/loop.py", "run"),
})

# Calls that are fine as defaults: immutable factories, plus
# dataclasses.field — the sanctioned per-instance construction hook.
_IMMUTABLE_FACTORIES = {"frozenset", "tuple", "dtype", "field"}
_SYNC_METHODS = {"item", "tolist", "numpy", "cpu"}
_LAUNCH_TAILS = {"CDLL", "_lib", "_banked_lib"}
_RNG_TAILS = ("normal_", "bernoulli", "bernoulli_")
_REFERENCE_PACKAGES = {"jax", "jaxlib", "repro"}


def _dotted(node: ast.AST) -> str:
    """'a.b.c' for an Attribute/Name chain, '' otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _module_name(rel: str) -> str:
    """'src/repro_torch/core/aeq.py' -> 'repro_torch.core.aeq'."""
    parts = rel.replace("\\", "/").removesuffix(".py").split("/")
    if parts[0] == "src":
        parts = parts[1:]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _units(tree: ast.Module) -> dict[str, ast.AST]:
    """Top-level functions ('f') and methods of top-level classes
    ('C.m'): the call graph's nodes; nested functions belong to theirs."""
    out: dict[str, ast.AST] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


def _imports(tree: ast.Module, module: str, is_pkg: bool
             ) -> dict[str, str]:
    """Local name -> the dotted path it names ('pkg.mod' or 'pkg.mod.f'),
    relative imports resolved against ``module``."""
    out: dict[str, str] = {}
    package = module if is_pkg else module.rpartition(".")[0]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = package.split(".")
                up = up[:len(up) - (node.level - 1)]
                base = ".".join(up + ([node.module] if node.module else []))
            for a in node.names:
                out[a.asname or a.name] = f"{base}.{a.name}"
    return out


def hot_units(trees: dict[str, ast.Module]) -> dict[str, set[str]]:
    """rel path -> qualified names of its hot units: the :data:`HOT_ROOTS`
    and every unit of ``trees`` they reference (a call, or a function
    passed on), transitively."""
    mods = {_module_name(rel): rel for rel in trees}
    units = {rel: _units(t) for rel, t in trees.items()}
    imports = {rel: _imports(t, _module_name(rel), rel.endswith("__init__.py"))
               for rel, t in trees.items()}

    def resolve(path: str) -> Optional[tuple[str, str]]:
        mod, _, name = path.rpartition(".")
        if mod in mods and name in units[mods[mod]]:
            return mods[mod], name
        return None

    def edges(rel: str, qual: str) -> set[tuple[str, str]]:
        cls = qual.split(".")[0] if "." in qual else None
        out = set()
        for node in ast.walk(units[rel][qual]):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                if node.id in units[rel]:
                    out.add((rel, node.id))
                elif node.id in imports[rel]:
                    hit = resolve(imports[rel][node.id])
                    if hit:
                        out.add(hit)
            elif isinstance(node, ast.Attribute):
                head = _dotted(node.value)
                if head == "self" and cls and \
                        f"{cls}.{node.attr}" in units[rel]:
                    out.add((rel, f"{cls}.{node.attr}"))
                elif head in imports[rel]:
                    hit = resolve(f"{imports[rel][head]}.{node.attr}")
                    if hit:
                        out.add(hit)
        return out

    todo = [(rel, qual) for rel in trees for suffix, qual in HOT_ROOTS
            if rel.replace("\\", "/").endswith(suffix) and qual in units[rel]]
    seen = set(todo)
    while todo:
        for nxt in edges(*todo.pop()):
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
    out: dict[str, set[str]] = {rel: set() for rel in trees}
    for rel, qual in seen:
        out[rel].add(qual)
    return out


def _is_blocking_transfer(node: ast.Call) -> bool:
    """A ``.to(...)`` that names a device and not ``non_blocking=True``;
    a dtype-only ``.to`` moves nothing."""
    for kw in node.keywords:
        if kw.arg == "non_blocking":
            return not (isinstance(kw.value, ast.Constant)
                        and kw.value.value is True)
    if any(kw.arg == "device" for kw in node.keywords):
        return True
    if not node.args:
        return False
    arg = node.args[0]
    if isinstance(arg, ast.Constant):
        return isinstance(arg.value, str)
    if isinstance(arg, ast.Call):
        return _dotted(arg.func).endswith("device")
    name = _dotted(arg).rsplit(".", 1)[-1]
    return "device" in name or name in ("dev", "cuda", "cpu")


class _Lints(ast.NodeVisitor):
    def __init__(self, rel: str, lines: list[str], in_kernels: bool,
                 hot: set[str], report: Report) -> None:
        self.rel = rel
        self.lines = lines
        self.in_kernels = in_kernels
        self.hot = hot
        self.rep = report
        self._qual: list[str] = []     # enclosing class / function names
        self._hot_depth = 0            # > 0 inside a hot unit

    # -- suppression ----------------------------------------------------
    def _suppressed(self, lineno: int, rule: str) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = IGNORE_RE.search(self.lines[ln - 1])
                if m and rule in {r.strip() for r in m.group(1).split(",")}:
                    return True
        return False

    def _flag(self, rule: str, node: ast.AST, message: str) -> None:
        if self._suppressed(node.lineno, rule):
            self.rep.proved(rule)
            return
        self.rep.flag("lint", rule, f"{self.rel}:{node.lineno}", message)

    # -- rule: mutable defaults ----------------------------------------
    def _check_default(self, node: ast.AST) -> None:
        if node is None:
            return
        bad = None
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            bad = "a mutable literal"
        elif isinstance(node, ast.Call):
            head = _dotted(node.func).rsplit(".", 1)[-1]
            if head not in _IMMUTABLE_FACTORIES:
                bad = f"a call ({_dotted(node.func) or 'expression'}(...))"
        if bad is None:
            self.rep.proved("lint-mutable-default")
        else:
            self._flag(
                "lint-mutable-default", node,
                f"default value is {bad}, evaluated once and shared "
                f"across every call — use None and construct inside")

    def _visit_fn(self, node) -> None:
        for d in list(node.args.defaults) + list(node.args.kw_defaults):
            self._check_default(d)
        self._qual.append(node.name)
        hot = ".".join(self._qual) in self.hot
        self._hot_depth += hot
        if hot:
            self.rep.proved("lint-host-sync-in-hot-path")
        self.generic_visit(node)
        self._hot_depth -= hot
        self._qual.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        is_dc = any("dataclass" in _dotted(
            d.func if isinstance(d, ast.Call) else d)
            for d in node.decorator_list)
        if is_dc:
            for stmt in node.body:
                if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                    self._check_default(stmt.value)
                elif isinstance(stmt, ast.Assign):
                    self._check_default(stmt.value)
        self._qual.append(node.name)
        self.generic_visit(node)
        self._qual.pop()

    # -- rule: reference imports -----------------------------------------
    def _check_import(self, node: ast.AST, module: str) -> None:
        if module.split(".")[0] in _REFERENCE_PACKAGES:
            self._flag("lint-reference-import", node,
                       f"import of '{module}': the port imports neither JAX "
                       f"nor the JAX package (keep a copy of what it needs)")
        else:
            self.rep.proved("lint-reference-import")

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self._check_import(node, a.name)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level == 0:
            self._check_import(node, node.module or "")

    # -- call rules ------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        head = _dotted(node.func)
        tail = head.rsplit(".", 1)[-1] if head else (
            node.func.attr if isinstance(node.func, ast.Attribute) else "")

        if tail in _LAUNCH_TAILS or head == "runtime.load" or \
                head.endswith(".runtime.load"):
            if self.in_kernels:
                self.rep.proved("lint-kernel-launch-outside-kernels")
            else:
                self._flag(
                    "lint-kernel-launch-outside-kernels", node,
                    f"'{head or tail}' outside kernels/ launches around the "
                    f"wrappers: their checks, CPU switch and launch "
                    f"counters")

        if (head.startswith("torch.") and tail.startswith("rand")) or \
                tail in _RNG_TAILS:
            if any(kw.arg == "generator" for kw in node.keywords):
                self.rep.proved("lint-global-rng")
            else:
                self._flag("lint-global-rng", node,
                           f"'{head or tail}' draws from the global generator "
                           f"— pass generator=")

        if self._hot_depth and isinstance(node.func, ast.Attribute):
            sync = None
            if tail in _SYNC_METHODS:
                sync = f".{tail}() copies to the host"
            elif head.endswith("cuda.synchronize"):
                sync = "torch.cuda.synchronize waits for the device"
            elif tail == "to" and _is_blocking_transfer(node):
                sync = ".to(<device>) without non_blocking=True waits for " \
                       "the device"
            if sync:
                self._flag("lint-host-sync-in-hot-path", node,
                           f"{sync} inside hot function "
                           f"'{'.'.join(self._qual)}', which the launch "
                           f"loop runs without a host sync")
        self.generic_visit(node)


def lint_source(source: str, filename: str,
                report: Optional[Report] = None, *,
                hot: Optional[set[str]] = None) -> Report:
    """Lint one file's source text.  ``filename`` scopes the rules (the
    kernels/ exemption, the hot roots); ``hot`` names the file's hot units
    (:func:`hot_units` over the whole tree), by default those this file
    reaches alone."""
    rep = report if report is not None else Report()
    try:
        tree = ast.parse(source, filename=filename)
    except SyntaxError as exc:
        rep.flag("lint", "lint-syntax", f"{filename}:{exc.lineno or 0}",
                 f"file does not parse: {exc.msg}")
        return rep
    if hot is None:
        hot = hot_units({filename: tree})[filename]
    in_kernels = "/kernels/" in "/" + filename.replace("\\", "/")
    _Lints(filename, source.splitlines(), in_kernels, hot, rep).visit(tree)
    rep.proved("lint-kernel-launch-outside-kernels")  # file scanned
    return rep


def _root() -> Path:
    return Path(__file__).resolve().parents[3]


def _default_paths() -> list[Path]:
    root = _root()
    return [root / "src" / "repro_torch", root / "chip_smoke.py"]


def _iter_py(paths: Iterable[Path]) -> Iterable[Path]:
    for p in paths:
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            yield from sorted(p.rglob("*.py"))


def run_lint(paths: Optional[Iterable[Path]] = None,
             report: Optional[Report] = None) -> Report:
    """Lint every file under ``paths`` (default: the port and
    chip_smoke.py), the hot units read from their joint call graph."""
    rep = report if report is not None else Report()
    root = _root()
    sources: dict[str, str] = {}
    for path in _iter_py(_default_paths() if paths is None else
                         [Path(p) for p in paths]):
        try:
            rel = str(path.resolve().relative_to(root))
        except ValueError:
            rel = str(path)
        sources[rel] = path.read_text()
    trees = {}
    for rel, src in sources.items():
        try:
            trees[rel] = ast.parse(src, filename=rel)
        except SyntaxError:
            pass  # lint_source flags it
    hot = hot_units(trees)
    for rel, src in sources.items():
        lint_source(src, rel, report=rep, hot=hot.get(rel, set()))
    return rep
