"""The path-scoped AST lint over the port's source (ref staticcheck/rules.py).

Each rule bans a set of calls in a set of path prefixes; a finding on a
line is suppressed by a ``# staticcheck: allow(<rule-id>)`` pragma on any
line the call spans, or in a comment block just above it (the pragma is
the machine-readable half, the reason written after it the human half).
Every pragma must suppress something: one that no longer does, names an
unknown rule or a rule not scoped to its path is a ``stale-pragma``
finding.

The rules guard the round path of one GPU: no host synchronisation or
device read between a round's launches (``torch.cuda.synchronize``,
``Event.synchronize``, ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``float()`` of a tensor) -- the one fetch a superstep goes
through ``parallel/staging.host_fetch``; no wall clock and no unseeded
generator where steps are built (a captured step replays what it
captured); and no library call standing in for a hand-written kernel's
work (``no-library-kernel``).  The reference's ``jit-needs-donation`` has
no counterpart: the port has no ``jax.jit`` and no donation, its buffers
are written in place by construction, and what donation guards (a round's
memory doubling) is held by the audit's memory ceiling (:mod:`.memory`).
``.tolist()`` and ``.numpy()`` are also numpy methods, which the AST
cannot tell from a tensor's: a host array's use carries a pragma saying
so.

Pure AST and the standard library: the lint runs without torch.
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .report import Finding

PRAGMA_RE = re.compile(r"#\s*staticcheck:\s*allow\(([A-Za-z0-9_,\- ]+)\)")

#: modules whose plain ``import x`` already binds the canonical name
_CANONICAL_ROOTS = ("torch", "numpy", "time", "random")

#: tensor methods whose result ``float()``/``int()``/``bool()`` can only
#: read back from the device (the AST's one way to tell a tensor argument)
_TENSOR_RESULTS = ("sum", "mean", "max", "min", "amax", "amin", "norm", "abs", "prod",
                   "any", "all", "count_nonzero", "std", "var")


@dataclass(frozen=True)
class Rule:
    """One banned-call rule.

    ``calls``: canonical dotted names (``time.time``); ``prefixes``:
    canonical dotted prefixes (``torch._foreach_``); ``methods``: attribute
    names banned as method calls on any receiver; ``tensor_builtins``:
    builtins banned where their one argument is a ``torch.*`` call or a
    method call in :data:`_TENSOR_RESULTS`; ``unseeded``: canonical
    generator constructors banned unless ``.manual_seed(...)`` is called on
    the new object in the same expression.  ``paths``: repo-relative path
    prefixes the rule applies to."""

    id: str
    description: str
    paths: Tuple[str, ...]
    calls: Tuple[str, ...] = ()
    prefixes: Tuple[str, ...] = ()
    methods: Tuple[str, ...] = ()
    tensor_builtins: Tuple[str, ...] = ()
    unseeded: Tuple[str, ...] = ()
    #: flag a function-body ``import x`` whose name a module-level import
    #: already binds
    shadowed_imports: bool = False

    def applies_to(self, relpath: str) -> bool:
        rp = relpath.replace(os.sep, "/")
        return any(rp.startswith(p) or f"/{p}" in rp for p in self.paths)


_PKG = "heterofl_tpu_torch/"
_PARALLEL = (_PKG + "parallel/",)
#: the scheduler's, the codecs' and the probes' device halves run inside
#: a round like the engines; sched/__init__, obs/__init__ and the rest of
#: obs/ are host-side configuration and records, as in the reference
_SCHED = (_PKG + "sched/deadline", _PKG + "sched/buffer")
_OBS = (_PKG + "obs/probes", _PKG + "obs/hist")
_KERNEL = (_PKG + "ops/", _PKG + "models/", _PKG + "compress/") + _SCHED + _OBS
_TRACED = _PARALLEL + (_PKG + "fed/",) + _KERNEL
_DRIVER = (_PKG + "entry/",)
#: where a hand-written kernel's work is done: the kernels' modules and the
#: engines (round, grouped, sliced, centralised)
_ENGINES = (_PKG + "ops/", _PKG + "parallel/", _PKG + "fed/sliced", _PKG + "entry/central")

DEFAULT_RULES: Tuple[Rule, ...] = (
    Rule("no-block-until-ready",
         "host synchronisation on the round path: only a capture's set-up and the "
         "driver boundary may wait for the device",
         _PARALLEL + _KERNEL,
         calls=("torch.cuda.synchronize",),
         methods=("synchronize",)),
    Rule("no-device-get",
         "device-to-host read on the round path: metric sums stay on the device "
         "(PendingMetrics) until the one host_fetch of a superstep",
         _PARALLEL + _KERNEL,
         methods=("item", "tolist", "cpu", "numpy")),
    Rule("no-float-coercion",
         "float()/int()/bool() of a tensor waits for its copy to the host; fetch "
         "through PendingMetrics instead",
         _PARALLEL + _KERNEL,
         tensor_builtins=("float", "int", "bool")),
    Rule("no-wallclock",
         "wall-clock reads where steps are built: a captured step replays what it "
         "captured, so a clock read there is a constant",
         _TRACED,
         calls=("time.time", "time.perf_counter", "time.monotonic", "time.time_ns",
                "time.perf_counter_ns")),
    Rule("no-fresh-rng",
         "fresh-seeded or unseeded generator in engine code breaks the reproducible "
         "stream contract (fed.core.round_seed and the engines' client seeds own "
         "the streams)",
         _TRACED,
         calls=("numpy.random.default_rng", "numpy.random.seed", "numpy.random.RandomState",
                "random.seed", "random.random", "random.randint", "torch.manual_seed"),
         unseeded=("torch.Generator",)),
    Rule("no-shadowed-inline-import",
         "inline import of a module the file already imports at module level: it "
         "shadows the top-level binding for its scope and hides which imports a "
         "function really adds",
         _DRIVER,
         shadowed_imports=True),
    Rule("no-host-eval-in-driver",
         "host-side evaluation in the driver loop: with superstep_rounds > 1 the sBN "
         "and evaluation run inside the superstep (Evaluator.fused); host "
         "sbn_stats/eval_users/eval_global calls belong on the K=1 path or offline "
         "tools (pragma with the reason)",
         _DRIVER,
         methods=("sbn_stats", "eval_users", "eval_global")),
    Rule("no-library-kernel",
         "a library call standing in for a hand-written kernel's work (batch norm, "
         "the optimizer's update, attention, a compiled graph): the port's kernels "
         "are hand-written CUDA C++ with a plain PyTorch version beside each",
         _ENGINES,
         calls=("torch.nn.functional.batch_norm", "torch.batch_norm",
                "torch.native_batch_norm", "torch.compile",
                "torch.nn.functional.scaled_dot_product_attention"),
         prefixes=("torch._foreach_", "torch.optim.")),
)


@dataclass(frozen=True)
class PragmaEntry:
    """One ``# staticcheck: allow(...)`` comment: its line, the rule ids it
    licenses and the lines it covers."""

    line: int
    ids: Tuple[str, ...]
    covered: Tuple[int, ...]


def _collect_pragmas(src: str) -> Tuple[Dict[int, Set[str]], List[PragmaEntry]]:
    """(line -> allowed rule ids, pragma occurrences).  A pragma covers its
    own line; one in a standalone comment block also covers the statement
    line the block precedes.  Only real comments count (the source is
    tokenized), so a pragma-shaped line inside a string is neither a
    licence nor an obligation."""
    lines = src.splitlines()
    out: Dict[int, Set[str]] = {}
    entries: List[PragmaEntry] = []
    comment_lines: Optional[Set[int]] = None
    try:
        comment_lines = {tok.start[0]
                         for tok in tokenize.generate_tokens(io.StringIO(src).readline)
                         if tok.type == tokenize.COMMENT}
    except (tokenize.TokenError, SyntaxError, IndentationError):
        pass

    def add(i: int, ids: Set[str]) -> None:
        out.setdefault(i, set()).update(ids)

    for i, line in enumerate(lines, start=1):
        if comment_lines is not None and i not in comment_lines:
            continue
        m = PRAGMA_RE.search(line)
        if not m:
            continue
        ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
        covered = [i]
        add(i, ids)
        if line.lstrip().startswith("#"):
            j = i + 1
            while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
                add(j, ids)
                covered.append(j)
                j += 1
            if j <= len(lines):
                add(j, ids)
                covered.append(j)
        entries.append(PragmaEntry(i, tuple(sorted(ids)), tuple(covered)))
    return out, entries


def _alias_map(tree: ast.AST) -> Dict[str, str]:
    """local name -> canonical dotted prefix (``F`` ->
    ``torch.nn.functional``, ``np`` -> ``numpy``)."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] in _CANONICAL_ROOTS:
                    aliases[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module.split(".")[0] in _CANONICAL_ROOTS:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _qualname(node: ast.AST, aliases: Dict[str, str]) -> Optional[str]:
    """Canonical dotted name of a Name/Attribute chain, or None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(aliases.get(node.id, node.id))
    return ".".join(reversed(parts))


def _node_lines(node: ast.AST) -> Iterable[int]:
    lo = getattr(node, "lineno", None)
    if lo is None:
        return ()
    hi = getattr(node, "end_lineno", None) or lo
    return range(lo, hi + 1)


def _tensor_like(arg: ast.AST, aliases: Dict[str, str]) -> bool:
    """Whether the AST can tell ``arg`` is a tensor: a ``torch.*`` call, or
    a method call whose result is a reduction (:data:`_TENSOR_RESULTS`)."""
    if not isinstance(arg, ast.Call):
        return False
    qn = _qualname(arg.func, aliases)
    if qn is not None and qn.split(".")[0] in _CANONICAL_ROOTS:
        return qn.startswith("torch.")  # a module function: numpy's is a host value
    return isinstance(arg.func, ast.Attribute) and arg.func.attr in _TENSOR_RESULTS


def lint_source(src: str, relpath: str, rules: Sequence[Rule] = DEFAULT_RULES
                ) -> List[Finding]:
    """Lint one file's source; ``relpath`` decides which rules apply.  Every
    pragma is also audited for liveness (``stale-pragma``)."""
    active = [r for r in rules if r.applies_to(relpath)]
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Finding("syntax-error", f"{relpath}:{e.lineno or 0}", str(e))]
    aliases = _alias_map(tree)
    pragmas, pragma_entries = _collect_pragmas(src)
    if not active and not pragma_entries:
        return []
    findings: List[Finding] = []
    used: Set[Tuple[str, int]] = set()  # (rule id, covered line) that suppressed

    def report(rule: Rule, node: ast.AST, what: str) -> None:
        hit = [ln for ln in _node_lines(node) if rule.id in pragmas.get(ln, ())]
        if hit:
            used.update((rule.id, ln) for ln in hit)
            return
        findings.append(Finding(rule.id, f"{relpath}:{node.lineno}", f"{what}: "
                                f"{rule.description}"))

    shadow_rules = [r for r in active if r.shadowed_imports]
    if shadow_rules:
        top_names = set()
        for node in tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    top_names.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    top_names.add(a.asname or a.name)
        fn_imports: List[ast.AST] = []
        seen: Set[int] = set()
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(fn):
                if isinstance(sub, (ast.Import, ast.ImportFrom)) and id(sub) not in seen:
                    seen.add(id(sub))
                    fn_imports.append(sub)
        for node in fn_imports:
            for a in node.names:
                name = a.asname or (a.name if isinstance(node, ast.ImportFrom)
                                    else a.name.split(".")[0])
                if name in top_names:
                    for rule in shadow_rules:
                        report(rule, node, f"inline import of {name!r} already imported "
                               f"at module level")
                    break

    # generator constructors seeded in the same expression: X in X.manual_seed(...)
    seeded: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "manual_seed" and isinstance(node.func.value, ast.Call):
            seeded.add(id(node.func.value))

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        qn = _qualname(node.func, aliases)
        for rule in active:
            if qn is not None and (qn in rule.calls
                                   or any(qn.startswith(p) for p in rule.prefixes)):
                report(rule, node, f"call to {qn}")
            elif qn is not None and qn in rule.unseeded and id(node) not in seeded:
                report(rule, node, f"{qn}() not seeded in the same expression")
            elif rule.methods and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in rule.methods:
                report(rule, node, f"method call .{node.func.attr}()")
            elif rule.tensor_builtins and isinstance(node.func, ast.Name) \
                    and node.func.id in rule.tensor_builtins and len(node.args) == 1 \
                    and _tensor_like(node.args[0], aliases):
                report(rule, node, f"builtin {node.func.id}() of a tensor")

    known = {r.id for r in rules}
    active_ids = {r.id for r in active}
    for ent in pragma_entries:
        for rid in ent.ids:
            if rid not in known:
                findings.append(Finding("stale-pragma", f"{relpath}:{ent.line}",
                                        f"allow({rid}) names an unknown rule id; known ids: "
                                        f"{sorted(known)}"))
            elif rid not in active_ids:
                findings.append(Finding("stale-pragma", f"{relpath}:{ent.line}",
                                        f"allow({rid}) licenses a rule that is not scoped to "
                                        f"this path; remove it"))
            elif not any((rid, ln) in used for ln in ent.covered):
                findings.append(Finding("stale-pragma", f"{relpath}:{ent.line}",
                                        f"allow({rid}) no longer suppresses any `{rid}` "
                                        f"finding on the lines it covers; remove it"))
    return findings


def lint_paths(files: Iterable[Tuple[str, str]], rules: Sequence[Rule] = DEFAULT_RULES
               ) -> List[Finding]:
    """Lint ``(relpath, source)`` pairs."""
    out: List[Finding] = []
    for relpath, src in files:
        out.extend(lint_source(src, relpath, rules))
    return out


def lint_tree(root: str, rules: Sequence[Rule] = DEFAULT_RULES,
              subdirs: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every ``.py`` file under ``root`` (or its ``subdirs``).  Paths
    are prefixed with ``root``'s own directory name, so the rules' scopes
    resolve when ``root`` is the package itself."""
    pairs: List[Tuple[str, str]] = []
    findings: List[Finding] = []
    prefix = os.path.basename(os.path.abspath(root))
    roots = [os.path.join(root, s) for s in subdirs] if subdirs else [root]
    for base in roots:
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in (".git", "__pycache__"))
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.join(prefix, os.path.relpath(full, root))
                try:
                    with open(full, encoding="utf-8") as f:
                        pairs.append((rel, f.read()))
                except OSError as e:
                    findings.append(Finding("unreadable", rel, str(e)))
    return findings + lint_paths(pairs, rules)


def lint_package(rules: Sequence[Rule] = DEFAULT_RULES) -> List[Finding]:
    """Lint the installed ``heterofl_tpu_torch`` package's own tree."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return lint_tree(pkg, rules)
