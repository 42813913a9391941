"""AST determinism lint (pillar 2 of ggrs-verify).

Rollback netcode's core invariant is bit-identical resimulation: every
peer must derive the same state from the same confirmed inputs, and a
migrated/failed-over incarnation must derive the same state from the
same bundle.  Anything nondeterministic that leaks into that derivation
— wall-clock reads, process-salted hashes, unordered-set iteration,
unseeded RNG, interpreter-dependent pickle encodings — desyncs a fleet
in ways no unit test reliably catches (the chaos ``shard_migrate`` leg
needed a specific loss seed to expose one).  This lint rejects the
whole class at the source level.

Scopes (``DET_SCOPE``):

- ``sim`` — rollback-visible code: ``core/``, ``games/``, ``ops/``,
  ``sessions/``, plus the journal/checkpoint modules whose bytes feed
  recovery.  All rules apply.
- ``bundle`` — the migration/resume-bundle and RPC seams.  The
  pickle-stability and set-iteration rules apply (their outputs cross
  process/host boundaries); wall-clock is allowed (watchdogs and
  metrics legitimately read real time there).

Suppression: a line comment ``# ggrs-verify: allow(<rule>[, <rule>])``
acknowledges a reviewed exception in place; the committed baseline
(``determinism_baseline.json``) carries the legacy remainder so new
violations fail while old ones burn down.

Rules:

====================  =====================================================
det/wall-clock        ``time.time()``/``monotonic``/``perf_counter``/
                      ``*_ns`` variants, ``datetime.now/utcnow/today``
det/unseeded-rng      module-level ``random.*`` calls, no-arg
                      ``random.Random()``, ``np.random.*``,
                      ``os.urandom``, ``uuid.uuid1/uuid4``, ``secrets.*``;
                      torch's process-global generator: ``torch.rand``/
                      ``randn``/``randint``/``randperm``/``normal``/
                      ``bernoulli``/``multinomial`` and the in-place
                      ``Tensor.uniform_``-style samplers without
                      ``generator=``, ``torch.manual_seed``/``seed`` (and
                      their ``torch.cuda`` twins)
det/set-iteration     iterating a set/frozenset (for/comprehension/
                      ``list``/``tuple``/``join``/``enumerate``) without
                      a ``sorted(...)`` wrapper
det/hash-order        builtin ``hash()`` (PYTHONHASHSEED-salted for
                      str/bytes) and ``sorted(key=id)`` /
                      ``.sort(key=id)``
det/jit-float-reduce  builtin ``sum()`` inside compiled code: a jax/Pallas
                      jit-decorated function, or the port's compiled
                      shapes — ``torch.compile``, ``torch.jit.script``/
                      ``trace``, ``triton.jit`` (as decorators or applied
                      to a function by name), a ``with
                      torch.cuda.graph(...)`` capture body and a function
                      handed to ``torch.cuda.make_graphed_callables``
                      (unspecified reduction order over floats)
det/pickle-protocol   ``pickle.dumps`` without an explicit fixed
                      ``protocol=`` (or with ``HIGHEST_PROTOCOL``, which
                      is interpreter-dependent) on the bundle/RPC seams
====================  =====================================================
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .report import PKG, Finding, allow_pragmas, is_allowed

# rule id -> one-line catalog entry (DESIGN.md §20 renders this)
DETERMINISM_RULES: Dict[str, str] = {
    "det/wall-clock": "wall-clock read in rollback-visible code",
    "det/unseeded-rng": "unseeded / process-global RNG",
    "det/set-iteration": "iteration over an unordered set",
    "det/hash-order": "process-salted hash() or id()-keyed ordering",
    "det/jit-float-reduce": "builtin sum() inside jitted sim code",
    "det/pickle-protocol": "unpinned pickle protocol on a bundle seam",
}


def det_scope(pkg: str = PKG) -> Tuple[Tuple[str, str], ...]:
    """``(scope, repo-relative prefix or exact file)`` rows for one
    package's tree."""
    return (
        ("sim", f"{pkg}/core/"),
        ("sim", f"{pkg}/games/"),
        ("sim", f"{pkg}/ops/"),
        ("sim", f"{pkg}/sessions/"),
        ("sim", f"{pkg}/broadcast/journal.py"),
        ("sim", f"{pkg}/utils/checkpoint.py"),
        # rollback-visible despite living in parallel/: the pool's staging
        # and replay paths feed the sessions' input queues directly
        ("sim", f"{pkg}/parallel/session_pool.py"),
        ("bundle", f"{pkg}/parallel/host_bank.py"),
        ("bundle", f"{pkg}/fleet/rpc.py"),
        ("bundle", f"{pkg}/fleet/shard.py"),
        ("bundle", f"{pkg}/fleet/supervisor.py"),
        ("bundle", f"{pkg}/fleet/proc.py"),
    )


DET_SCOPE: Tuple[Tuple[str, str], ...] = det_scope()

# rules active per scope
_SCOPE_RULES = {
    "sim": (
        "det/wall-clock", "det/unseeded-rng", "det/set-iteration",
        "det/hash-order", "det/jit-float-reduce", "det/pickle-protocol",
    ),
    "bundle": ("det/set-iteration", "det/pickle-protocol"),
}

_WALL_CLOCK_TIME = {
    "time", "time_ns", "monotonic", "monotonic_ns", "perf_counter",
    "perf_counter_ns", "process_time", "process_time_ns", "localtime",
    "gmtime",
}
_WALL_CLOCK_DATETIME = {"now", "utcnow", "today"}
_RANDOM_MODULE_FNS = {
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "getrandbits", "gauss", "normalvariate",
    "betavariate", "expovariate", "seed",
}
_UUID_NONDET = {"uuid1", "uuid4"}
# torch's samplers that draw from the process-global generator unless
# handed ``generator=``
_TORCH_SAMPLERS = {
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
}
_TORCH_INPLACE_SAMPLERS = {
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}
_TORCH_GLOBAL_SEED = {
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
    "torch.random.manual_seed", "torch.random.seed",
}
# the port's compiled-code wrappers, as decorators or applied by name
_TORCH_COMPILERS = {
    "torch.compile", "torch.jit.script", "torch.jit.trace", "triton.jit",
}
_TORCH_GRAPH_CAPTURE = {"torch.cuda.graph"}
_TORCH_GRAPHED = {"torch.cuda.make_graphed_callables"}

def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in ("set", "frozenset")
    return False


def _is_jit_decorator(
    dec: ast.AST, aliases: Optional[Dict[str, str]] = None
) -> bool:
    """jax.jit / jit / partial(jax.jit, ...) / jax.pmap / pl.pallas_call
    shapes, and the port's torch.compile / torch.jit.script /
    torch.jit.trace / triton.jit (bare, called, or under partial) —
    anything that compiles the body for the device."""
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _dotted(target)
    if name in ("jit", "jax.jit", "jax.pmap", "pmap", "pjit",
                "jax.experimental.pjit.pjit", "pl.pallas_call",
                "pallas_call"):
        return True
    if _resolve_alias(name, aliases) in _TORCH_COMPILERS:
        return True
    if isinstance(dec, ast.Call) and _dotted(dec.func) in (
        "functools.partial", "partial"
    ):
        return any(
            _dotted(a) in ("jit", "jax.jit", "jax.pmap")
            or _resolve_alias(_dotted(a), aliases) in _TORCH_COMPILERS
            for a in dec.args
        )
    return False


def _resolve_alias(
    name: Optional[str], aliases: Optional[Dict[str, str]]
) -> Optional[str]:
    """``name`` with its head resolved through the file's import aliases
    ('monotonic' -> 'time.monotonic', 't.monotonic' -> 'time.monotonic'
    for 'import time as t', 'tc' -> 'torch.compile' for 'from torch
    import compile as tc')."""
    if name is None or not aliases:
        return name
    head, _, rest = name.partition(".")
    if head in aliases:
        return aliases[head] + ("." + rest if rest else "")
    return name


def _compiled_by_name(
    tree: ast.Module, aliases: Dict[str, str]
) -> Set[str]:
    """Names of functions compiled by a call rather than a decorator:
    ``step = torch.compile(step)``, ``torch.jit.script(fn)``,
    ``torch.cuda.make_graphed_callables(fn, ...)`` (one callable or a
    tuple of them)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        name = _resolve_alias(_dotted(node.func), aliases)
        if name not in _TORCH_COMPILERS and name not in _TORCH_GRAPHED:
            continue
        first = node.args[0]
        elts = first.elts if isinstance(first, (ast.Tuple, ast.List)) \
            else [first]
        out.update(e.id for e in elts if isinstance(e, ast.Name))
    return out


# modules whose from-imports must resolve back to dotted form so
# `from time import monotonic; monotonic()` is as visible to the rules
# as `time.monotonic()`
_TRACKED_MODULES = (
    "time", "random", "datetime", "os", "uuid", "secrets", "pickle",
    "torch", "torch.cuda", "torch.jit", "triton",
)


def _from_import_aliases(tree: ast.Module) -> Dict[str, str]:
    """``{local_name: "module.attr"}`` for from-imports of the tracked
    nondeterminism modules (one level; star imports are out of reach)."""
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module in \
                _TRACKED_MODULES:
            for a in node.names:
                if a.name != "*":
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.asname and a.name in _TRACKED_MODULES:
                    out[a.asname] = a.name  # import time as t -> t.*
    return out


class _DetVisitor(ast.NodeVisitor):
    def __init__(
        self,
        path: str,
        rules: Iterable[str],
        aliases: Optional[Dict[str, str]] = None,
        compiled: Iterable[str] = (),
    ) -> None:
        self.path = path
        self.rules = set(rules)
        self.aliases = aliases or {}
        self.compiled = set(compiled)
        self.findings: List[Finding] = []
        self._jit_depth = 0

    def _resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted name of a call target, with from-import aliases
        resolved ('monotonic' -> 'time.monotonic', 't.monotonic' ->
        'time.monotonic' for 'import time as t')."""
        return _resolve_alias(_dotted(node), self.aliases)

    # -- helpers --------------------------------------------------------
    def _hit(self, rule: str, node: ast.AST, detail: str) -> None:
        if rule in self.rules:
            self.findings.append(
                Finding(rule, self.path, getattr(node, "lineno", 0), detail)
            )

    # -- function bodies (jit tracking) ---------------------------------
    def _visit_func(self, node) -> None:
        jitted = node.name in self.compiled or any(
            _is_jit_decorator(d, self.aliases) for d in node.decorator_list
        )
        if jitted:
            self._jit_depth += 1
        self.generic_visit(node)
        if jitted:
            self._jit_depth -= 1

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def visit_With(self, node: ast.With) -> None:
        """A ``with torch.cuda.graph(g):`` body is captured once and
        replayed: it is compiled device code like a jitted body."""
        captured = any(
            isinstance(item.context_expr, ast.Call)
            and self._resolve(item.context_expr.func)
            in _TORCH_GRAPH_CAPTURE
            for item in node.items
        )
        if captured:
            self._jit_depth += 1
        self.generic_visit(node)
        if captured:
            self._jit_depth -= 1

    # -- iteration forms -------------------------------------------------
    def visit_For(self, node: ast.For) -> None:
        if _is_set_expr(node.iter):
            self._hit(
                "det/set-iteration", node,
                "for-loop over a set: iteration order is unordered",
            )
        self.generic_visit(node)

    def _visit_comp(self, node) -> None:
        for gen in node.generators:
            if _is_set_expr(gen.iter):
                self._hit(
                    "det/set-iteration", node,
                    "comprehension over a set: iteration order is "
                    "unordered",
                )
        self.generic_visit(node)

    visit_ListComp = _visit_comp
    visit_GeneratorExp = _visit_comp
    visit_DictComp = _visit_comp
    visit_SetComp = _visit_comp

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = self._resolve(node.func)

        # wall clock
        if name is not None:
            mod, _, attr = name.rpartition(".")
            if mod == "time" and attr in _WALL_CLOCK_TIME:
                self._hit("det/wall-clock", node,
                          f"{name}() reads the wall clock")
            elif attr in _WALL_CLOCK_DATETIME and mod.endswith("datetime"):
                self._hit("det/wall-clock", node,
                          f"{name}() reads the wall clock")
            # unseeded / process-global RNG
            elif mod == "random" and attr in _RANDOM_MODULE_FNS:
                self._hit("det/unseeded-rng", node,
                          f"{name}() uses the process-global RNG")
            elif name == "random.Random" and not node.args and not \
                    node.keywords:
                self._hit("det/unseeded-rng", node,
                          "random.Random() without a seed")
            elif mod.split(".")[-1] == "random" and \
                    mod.split(".")[0] in ("np", "numpy"):
                # np.random.* is the process-global legacy RNG.
                # jax.random is deliberately NOT here: it is functional
                # and explicitly keyed.
                self._hit("det/unseeded-rng", node,
                          f"{name}() uses a process-global RNG")
            elif (
                mod == "torch" and attr in _TORCH_SAMPLERS
                and not any(k.arg == "generator" for k in node.keywords)
            ):
                self._hit("det/unseeded-rng", node,
                          f"{name}() without generator= draws from "
                          "torch's process-global RNG")
            elif name in _TORCH_GLOBAL_SEED:
                self._hit("det/unseeded-rng", node,
                          f"{name}() reseeds torch's process-global RNG")
            elif name == "os.urandom" or mod == "secrets":
                self._hit("det/unseeded-rng", node,
                          f"{name}() is entropy, not simulation state")
            elif mod == "uuid" and attr in _UUID_NONDET:
                self._hit("det/unseeded-rng", node,
                          f"{name}() is host/time-dependent")
            # pickle stability
            elif name in ("pickle.dumps", "pickle.dump"):
                # positional protocol: dumps(obj, protocol) is args[1],
                # dump(obj, file, protocol) is args[2]
                pos = 1 if name == "pickle.dumps" else 2
                proto = next(
                    (k.value for k in node.keywords if k.arg == "protocol"),
                    node.args[pos] if len(node.args) > pos else None,
                )
                if proto is None or (
                    isinstance(proto, ast.Constant)
                    and proto.value is None
                ):
                    self._hit(
                        "det/pickle-protocol", node,
                        "pickle without an explicit protocol: the "
                        "default differs across interpreters",
                    )
                elif _dotted(proto) in (
                    "pickle.HIGHEST_PROTOCOL", "HIGHEST_PROTOCOL",
                    "pickle.DEFAULT_PROTOCOL", "DEFAULT_PROTOCOL",
                ):
                    self._hit(
                        "det/pickle-protocol", node,
                        f"{_dotted(proto)} is interpreter-dependent; "
                        "pin a numeric protocol",
                    )
                elif isinstance(proto, ast.UnaryOp) and isinstance(
                    proto.op, ast.USub
                ):
                    self._hit(
                        "det/pickle-protocol", node,
                        "protocol=-1 means highest-available: "
                        "interpreter-dependent; pin a numeric protocol",
                    )

        # builtin hash()/sum()/list(set)/...
        if isinstance(node.func, ast.Name):
            fid = node.func.id
            if fid == "hash":
                self._hit(
                    "det/hash-order", node,
                    "builtin hash() is PYTHONHASHSEED-salted for "
                    "str/bytes",
                )
            elif fid == "sum" and self._jit_depth > 0:
                self._hit(
                    "det/jit-float-reduce", node,
                    "builtin sum() inside jitted code: reduction order "
                    "over floats is unspecified",
                )
            elif fid in ("list", "tuple", "enumerate") and \
                    node.args and _is_set_expr(node.args[0]):
                self._hit(
                    "det/set-iteration", node,
                    f"{fid}() over a set: materialization order is "
                    "unordered (wrap in sorted())",
                )
            elif fid == "sorted":
                for k in node.keywords:
                    if k.arg == "key" and _dotted(k.value) == "id":
                        self._hit(
                            "det/hash-order", node,
                            "sorted(key=id): address order varies per "
                            "process",
                        )
        elif isinstance(node.func, ast.Attribute):
            if node.func.attr in _TORCH_INPLACE_SAMPLERS and not any(
                k.arg == "generator" for k in node.keywords
            ):
                self._hit(
                    "det/unseeded-rng", node,
                    f".{node.func.attr}() without generator= draws from "
                    "torch's process-global RNG",
                )
            if node.func.attr in ("join", "sort"):
                if node.func.attr == "join" and node.args and \
                        _is_set_expr(node.args[0]):
                    self._hit(
                        "det/set-iteration", node,
                        "join() over a set: order is unordered",
                    )
                if node.func.attr == "sort":
                    for k in node.keywords:
                        if k.arg == "key" and _dotted(k.value) == "id":
                            self._hit(
                                "det/hash-order", node,
                                ".sort(key=id): address order varies "
                                "per process",
                            )
        self.generic_visit(node)


def lint_source(
    source: str, rel_path: str, scope: str = "sim"
) -> List[Finding]:
    """Lint one file's source text under the given scope's rule set,
    honoring ``# ggrs-verify: allow(...)`` line pragmas."""
    tree = ast.parse(source)
    aliases = _from_import_aliases(tree)
    visitor = _DetVisitor(
        rel_path, _SCOPE_RULES[scope], aliases,
        _compiled_by_name(tree, aliases),
    )
    visitor.visit(tree)
    allows = allow_pragmas(source.splitlines())
    return [
        f for f in visitor.findings
        if not is_allowed(f.rule, allows.get(f.line, set()))
    ]


def lint_determinism(
    root: Path, scope_map: Sequence[Tuple[str, str]] = DET_SCOPE
) -> List[Finding]:
    """Lint every in-scope file under ``root``; sorted findings."""
    root = Path(root)
    findings: List[Finding] = []
    seen = set()
    for scope, prefix in scope_map:
        target = root / prefix
        files = (
            sorted(target.rglob("*.py")) if target.is_dir() else [target]
        )
        for path in files:
            if not path.exists() or path in seen:
                continue
            seen.add(path)
            rel = path.relative_to(root).as_posix()
            findings.extend(lint_source(path.read_text(), rel, scope))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
