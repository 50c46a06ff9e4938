"""Knob-drift linter of the port (counterpart of
``horovod_tpu/analysis/knob_lint.py``, rule family ``KNOB-*``).

The port's registry (:mod:`horovod_tpu_torch.common.config`) is the one
surface every knob flows through.  This pass holds the same
cross-references as the JAX package's, each pointed at the port's own
counterpart of what it checks:

* ``KNOB-RAW-ENV`` — a ``HOROVOD_*`` env var read outside
  ``common/config.py`` anywhere in ``horovod_tpu_torch/``.
* ``KNOB-TRACE-SEMANTICS`` — a knob read by the data plane
  (:data:`DATA_PLANE_MODULES`: the eager executor, the in-trace
  collectives, overlap, compression, quantization and the mesh's hops)
  that ``runtime/controller.py:round0_cfg`` does not validate.
* ``KNOB-HANDSHAKE-MISSING`` / ``KNOB-HANDSHAKE-HELP`` — the help text
  and the handshake vector must agree about which knobs claim
  cross-rank agreement.
* ``KNOB-CACHEKEY`` — the port has no program cache; the hazard it
  stood for is a handshake knob latched into state that outlives one
  response.  The seeds are what the data plane memoizes across
  responses (:func:`memo_sites`: ``functools.lru_cache``-style
  decorators, module-level containers written by functions, module
  globals rebound by functions, instance attributes built lazily
  under an ``if`` on themselves); a knob read into such a value that
  its key (the subscript, the guard) cannot see is flagged.
* ``KNOB-AOT-KEY`` — the AOT cache (``runtime/aot_cache.py``) must
  key its programs on ``round0_cfg()``.
* ``KNOB-CLI-REGISTRY`` — ``run/launcher.py`` builds its flags from
  the registry.
* ``KNOB-BENCH-DRIFT`` — the bench scripts that the benchmark's
  manifest (:data:`BENCHMARK_JSON`) names must not invent env names;
  while the checkout has no manifest the rule reads nothing and
  :func:`skipped` says so, and a manifest that names no script in the
  checkout is a finding.
* ``KNOB-DOC-MISSING`` — every registered knob has a row in
  ``docs/*.md`` or ``README.md``.
* ``KNOB-DEAD`` — every registered knob has a reader in the package
  (or a bench script).

Everything here is AST-based: no module under lint is imported; the
only import is the stdlib-only registry.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field

from horovod_tpu_torch.analysis import PACKAGE
from horovod_tpu_torch.analysis.findings import Finding

# Env names that are deliberately NOT registry knobs: launcher-assigned
# process identity / cross-process coordination values.  They are still
# flagged when read raw inside the package (the allowlist carries the
# per-file justification); this set only exempts them from the bench
# CLI-drift rule, where mentioning them is not "inventing a knob".
COORDINATION_ENV = frozenset({
    "HOROVOD_RANK", "HOROVOD_SIZE", "HOROVOD_LOCAL_RANK",
    "HOROVOD_LOCAL_SIZE", "HOROVOD_CROSS_RANK", "HOROVOD_CROSS_SIZE",
    "HOROVOD_TPU_RANK", "HOROVOD_HOSTNAMES", "HOROVOD_SECRET_KEY",
    "HOROVOD_ELASTIC_JOINER", "HOROVOD_ELASTIC_UID",
    "HOROVOD_ELASTIC_NP", "HOROVOD_RESTART_ATTEMPT",
    "HOROVOD_RESUME_STEP", "HOROVOD_RUNFUNC_NO_SHARED_FS",
})
# Operator-internal orchestration prefixes (bench probe machinery).
INTERNAL_PREFIXES = ("HOROVOD_BENCH_",)

# Help-text phrases that claim cross-rank agreement; the handshake
# vector and these markers must agree in both directions.
HANDSHAKE_MARKERS = ("round-0 handshake", "must agree on every rank")

# The data-plane modules: any config read here shapes the transfers
# each rank issues independently.
DATA_PLANE_MODULES = ("ops/eager_exec.py", "ops/collectives.py",
                      "ops/overlap.py", "ops/compression.py",
                      "ops/quantization.py", "parallel/mesh.py")

#: The benchmark's manifest at the checkout root; the bench scripts are
#: the ``.py`` files its strings name.  It arrives with the port's
#: benchmark; until then KNOB-BENCH-DRIFT reads nothing.
BENCHMARK_JSON = "BENCHMARK.json"
_PY_RE = re.compile(r"[\w./-]+\.py\b")

CONFIG_PY = f"{PACKAGE}/common/config.py"
CONTROLLER_PY = f"{PACKAGE}/runtime/controller.py"
AOT_CACHE_PY = f"{PACKAGE}/runtime/aot_cache.py"
LAUNCHER_PY = f"{PACKAGE}/run/launcher.py"

_CONFIG_ALIASES = {"config", "_config", "_bconfig"}
_ENV_RE = re.compile(r"HOROVOD_[A-Z0-9_]+")

#: Decorators that memoize a function's result on its arguments.
_MEMO_DECORATORS = frozenset({"lru_cache", "cache", "cached_property"})
#: Constructors of a module-level container that can serve as a cache.
_CONTAINER_CTORS = frozenset({"dict", "list", "set", "OrderedDict",
                              "defaultdict", "WeakValueDictionary",
                              "WeakKeyDictionary"})
#: Methods that store into a container: (method, key arg, value arg).
_STORE_METHODS = {"setdefault": (0, 1), "update": (None, 0),
                  "append": (None, 0), "add": (None, 0)}


def _f(rule, loc, msg, hint="", severity="error") -> Finding:
    return Finding(rule=rule, severity=severity, location=loc,
                   message=msg, fix_hint=hint, pass_name="knobs")


# ---------------------------------------------------------------------------
# Per-module AST index
# ---------------------------------------------------------------------------


@dataclass
class FuncInfo:
    module: str                       # repo-relative path
    qualname: str
    node: ast.FunctionDef
    config_reads: set = field(default_factory=set)
    dynamic_get: bool = False         # config.get(<non-constant>)
    calls: list = field(default_factory=list)  # (callee expr, const str args)


@dataclass
class ModuleIndex:
    path: str                          # repo-relative
    tree: ast.AST
    funcs: dict = field(default_factory=dict)      # name -> FuncInfo
    #: EVERY FunctionDef, including ones shadowed in ``funcs`` by a
    #: same-named method elsewhere in the module.
    all_funcs: list = field(default_factory=list)
    aliases: dict = field(default_factory=dict)    # local name -> module path


def _is_config_get(call: ast.Call) -> bool:
    fn = call.func
    return (isinstance(fn, ast.Attribute)
            and fn.attr in ("get", "is_set")
            and isinstance(fn.value, ast.Name)
            and fn.value.id in _CONFIG_ALIASES)


def _const_str_args(call: ast.Call) -> list:
    return [a.value for a in call.args
            if isinstance(a, ast.Constant) and isinstance(a.value, str)]


def index_module(root: str, relpath: str) -> ModuleIndex:
    with open(os.path.join(root, relpath)) as f:
        tree = ast.parse(f.read(), filename=relpath)
    idx = ModuleIndex(path=relpath, tree=tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                name = alias.asname or alias.name
                # "from horovod_tpu_torch.ops import overlap as _ovl"
                # maps _ovl -> the module; "from ...compression import
                # f" maps f -> (module, f).
                idx.aliases[name] = (node.module, alias.name)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fi = FuncInfo(module=relpath, qualname=node.name, node=node)
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                if _is_config_get(sub):
                    consts = _const_str_args(sub)
                    if consts:
                        fi.config_reads.update(consts)
                    else:
                        fi.dynamic_get = True
                else:
                    fi.calls.append((sub.func, _const_str_args(sub)))
            # call RESOLUTION keys by bare name (last wins, matching
            # runtime rebinding); read COLLECTION keeps every def
            idx.funcs[node.name] = fi
            idx.all_funcs.append(fi)
    return idx


class _Modules:
    """Loaded module indexes keyed by repo-relative path, with call
    resolution across ``from X import y`` edges."""

    def __init__(self, root: str, relpaths: list):
        self.root = root
        self.by_path = {p: index_module(root, p) for p in relpaths
                        if os.path.exists(os.path.join(root, p))}
        # the repo-relative path spelled as a module IS the import name
        self.by_modname = {
            p.replace("/", ".").removesuffix(".py"): idx
            for p, idx in self.by_path.items()}

    def resolve(self, idx: ModuleIndex, func_expr) -> "FuncInfo | None":
        if isinstance(func_expr, ast.Name):
            if func_expr.id in idx.funcs:
                return idx.funcs[func_expr.id]
            tgt = idx.aliases.get(func_expr.id)
            if tgt:
                mod = self.by_modname.get(tgt[0])
                if mod and tgt[1] in mod.funcs:
                    return mod.funcs[tgt[1]]
        elif isinstance(func_expr, ast.Attribute) \
                and isinstance(func_expr.value, ast.Name):
            tgt = idx.aliases.get(func_expr.value.id)
            if tgt:
                modname = f"{tgt[0]}.{tgt[1]}"
                mod = self.by_modname.get(modname)
                if mod and func_expr.attr in mod.funcs:
                    return mod.funcs[func_expr.attr]
        return None

    def config_closure(self, seeds: list, knob_names: frozenset) -> set:
        """Transitive set of registry knob names read from ``seeds``
        (FuncInfo list): direct ``config.get("x")`` reads plus — for
        callees that read ``config.get(<dynamic>)`` — constant string
        arguments at the call site that name registered knobs."""
        seen_funcs, reads = set(), set()
        stack = list(seeds)
        while stack:
            fi = stack.pop()
            key = (fi.module, fi.qualname, fi.node.lineno)
            if key in seen_funcs:
                continue
            seen_funcs.add(key)
            reads.update(fi.config_reads)
            idx = self.by_path[fi.module]
            for func_expr, const_args in fi.calls:
                callee = self.resolve(idx, func_expr)
                if callee is None:
                    continue
                if callee.dynamic_get:
                    reads.update(a for a in const_args
                                 if a in knob_names)
                stack.append(callee)
        return reads

    def expr_reads(self, idx: ModuleIndex, exprs: list,
                   knob_names: frozenset) -> set:
        """Registry knobs an expression reads: ``config.get("x")`` in
        it, and the closure of every call in it that resolves."""
        reads, seeds = set(), []
        for expr in exprs:
            for sub in ast.walk(expr):
                if not isinstance(sub, ast.Call):
                    continue
                if _is_config_get(sub):
                    reads.update(_const_str_args(sub))
                    continue
                callee = self.resolve(idx, sub.func)
                if callee is not None:
                    seeds.append(callee)
                    if callee.dynamic_get:
                        reads.update(a for a in _const_str_args(sub)
                                     if a in knob_names)
        return (reads | self.config_closure(seeds, knob_names)) & knob_names


# ---------------------------------------------------------------------------
# Raw env-read scan
# ---------------------------------------------------------------------------


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id == "os")


def _env_const(node, consts=None) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value.startswith("HOROVOD_"):
        return node.value
    if consts and isinstance(node, ast.Name):
        # `_ENV_EVENTS = "HOROVOD_FLIGHT_EVENTS"` at module level,
        # read later via the name — still a raw env read.
        return consts.get(node.id)
    return None


def scan_env_reads(path: str) -> list:
    """(lineno, env_name) for every constant-key HOROVOD_* read of
    ``os.environ`` / ``os.getenv`` in ``path`` — literal keys plus
    module-level string-constant names.  Writes (``os.environ[k] =
    v``, ``setdefault``) are exempt: exporting a value is how the
    launcher/config hand knobs to children; READING one raw is what
    bypasses the registry."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, str) \
                and node.value.value.startswith("HOROVOD_"):
            consts[node.targets[0].id] = node.value.value
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr == "get" \
                    and _is_os_environ(fn.value) and node.args:
                name = _env_const(node.args[0], consts)
                if name:
                    hits.append((node.lineno, name))
            elif isinstance(fn, ast.Attribute) and fn.attr == "getenv" \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == "os" and node.args:
                name = _env_const(node.args[0], consts)
                if name:
                    hits.append((node.lineno, name))
        elif isinstance(node, ast.Subscript) \
                and isinstance(node.ctx, ast.Load) \
                and _is_os_environ(node.value):
            name = _env_const(node.slice, consts)
            if name:
                hits.append((node.lineno, name))
        elif isinstance(node, ast.Compare) \
                and len(node.ops) == 1 \
                and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                and any(_is_os_environ(c) for c in node.comparators):
            name = _env_const(node.left, consts)
            if name:
                hits.append((node.lineno, name))
    return hits


# ---------------------------------------------------------------------------
# What the data plane memoizes across responses (KNOB-CACHEKEY's seeds)
# ---------------------------------------------------------------------------


@dataclass
class MemoSite:
    module: str
    line: int
    what: str                 # human description of the memo
    func: object              # the FuncInfo the memo lives in
    values: list              # expressions whose result is kept
    keys: list                # expressions the kept value is keyed on
    whole: bool = False       # the function's whole result is kept


def _dotted_name(node) -> str:
    if isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _module_containers(tree: ast.AST) -> set:
    out = set()
    for node in tree.body:
        targets, value = [], None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        is_container = isinstance(value, (ast.Dict, ast.List, ast.Set)) \
            or (isinstance(value, ast.Call)
                and _dotted_name(value) in _CONTAINER_CTORS)
        if is_container:
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    return out


def _self_attr(node) -> str | None:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def memo_sites(idx: ModuleIndex) -> list:
    """Every place ``idx`` keeps a value beyond the call that built it."""
    containers = _module_containers(idx.tree)
    sites = []
    for fi in idx.all_funcs:
        node = fi.node
        for dec in node.decorator_list:
            name = _dotted_name(dec)
            if name in _MEMO_DECORATORS:
                sites.append(MemoSite(idx.path, node.lineno,
                                      f"@{name} {node.name}()", fi,
                                      [], [], whole=True))
        declared_global = {n for sub in ast.walk(node)
                           if isinstance(sub, ast.Global) for n in sub.names}
        guards: dict = {}         # id(assign) -> enclosing if-tests
        for sub in ast.walk(node):
            if isinstance(sub, ast.If):
                for inner in ast.walk(sub):
                    if inner is not sub:
                        guards.setdefault(id(inner), []).append(sub.test)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Subscript) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id in containers:
                        sites.append(MemoSite(
                            idx.path, sub.lineno,
                            f"module-level {t.value.id}[...]", fi,
                            [sub.value], [t.slice]))
                    elif isinstance(t, ast.Name) \
                            and t.id in declared_global \
                            and not (isinstance(sub.value, ast.Constant)
                                     and sub.value.value is None):
                        sites.append(MemoSite(
                            idx.path, sub.lineno,
                            f"module global {t.id}", fi, [sub.value],
                            guards.get(id(sub), [])))
                    elif _self_attr(t) is not None:
                        attr = _self_attr(t)
                        tests = [g for g in guards.get(id(sub), [])
                                 if any(_self_attr(x) == attr
                                        for x in ast.walk(g))]
                        if tests:
                            sites.append(MemoSite(
                                idx.path, sub.lineno,
                                f"lazily built self.{attr}", fi,
                                [sub.value], tests))
            elif isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Attribute) \
                    and isinstance(sub.func.value, ast.Name) \
                    and sub.func.value.id in containers \
                    and sub.func.attr in _STORE_METHODS:
                ki, vi = _STORE_METHODS[sub.func.attr]
                if vi >= len(sub.args):
                    continue
                sites.append(MemoSite(
                    idx.path, sub.lineno,
                    f"module-level {sub.func.value.id}."
                    f"{sub.func.attr}()", fi, [sub.args[vi]],
                    [sub.args[ki]] if ki is not None
                    and ki < len(sub.args) else []))
    return sites


def _one_step_back(fi: FuncInfo, exprs: list) -> list:
    """``exprs`` plus the right-hand sides of the function's local
    assignments to the names they use (``cap = ...; buf = f(cap)``)."""
    assigns: dict = {}
    for sub in ast.walk(fi.node):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                and isinstance(sub.targets[0], ast.Name):
            assigns.setdefault(sub.targets[0].id, []).append(sub.value)
    out = list(exprs)
    for e in exprs:
        for sub in ast.walk(e):
            if isinstance(sub, ast.Name):
                out.extend(assigns.get(sub.id, []))
    return out


def memo_findings(mods: _Modules, relpaths: list, handshake: set,
                  knobs: dict) -> list:
    """KNOB-CACHEKEY over ``relpaths``: a handshake knob read into a
    memoized value that the memo's key cannot see."""
    knob_names = frozenset(knobs)
    findings = []
    for rel in relpaths:
        idx = mods.by_path.get(rel)
        if idx is None:
            continue
        for site in memo_sites(idx):
            if site.whole:
                kept = mods.config_closure([site.func], knob_names)
                keyed: set = set()
            else:
                kept = mods.expr_reads(
                    idx, _one_step_back(site.func, site.values), knob_names)
                keyed = mods.expr_reads(
                    idx, _one_step_back(site.func, site.keys), knob_names)
            for name in sorted((kept & handshake) - keyed):
                findings.append(_f(
                    "KNOB-CACHEKEY", f"{rel}:{site.line}",
                    f"handshake knob '{name}' ({knobs[name].env}) is "
                    f"latched into the {site.what} in "
                    f"{site.func.qualname}(), which outlives one "
                    "response, and its key cannot see the knob — a "
                    "mid-run change would replay a value built under the "
                    "old value",
                    "fold the knob into the memo's key (or rebuild per "
                    "response), or allowlist with the reason the kept "
                    "value does not depend on it"))
    return findings


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------


def _package_files(pkg_root: str) -> list:
    out = []
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "csrc", "_build"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def run(package_dir: str | None = None) -> list:
    """Run the knob lint.  ``package_dir`` overrides the tree to scan
    for raw env reads (fixture trees); the registry cross-reference
    rules run only against the real package (a fixture tree has no
    registry to cross-reference)."""
    from horovod_tpu_torch.analysis import repo_root

    root = repo_root()
    findings = []

    fixture_mode = package_dir is not None
    scan_root = package_dir or os.path.join(root, PACKAGE)

    # (1) raw env reads
    for path in _package_files(scan_root):
        rel = os.path.relpath(path, package_dir or root)
        if not fixture_mode and rel.replace(os.sep, "/") == CONFIG_PY:
            continue
        loc_rel = os.path.relpath(path, root) if not fixture_mode else rel
        try:
            hits = scan_env_reads(path)
        except SyntaxError as exc:
            findings.append(_f("KNOB-RAW-ENV", f"{loc_rel}:1",
                               f"unparseable module: {exc}"))
            continue
        for lineno, env in hits:
            findings.append(_f(
                "KNOB-RAW-ENV", f"{loc_rel}:{lineno}",
                f"raw read of {env} outside common/config.py bypasses "
                "the knob registry (parsing, defaults, CLI/config-file "
                "surfaces)",
                "route through config.get()/config.is_set() or "
                "allowlist with a justification"))
    if fixture_mode:
        return findings

    findings.extend(_registry_rules(root))
    return findings


def bench_scripts(root: str) -> list | None:
    """The checkout-relative ``.py`` files that ``root``'s
    :data:`BENCHMARK_JSON` names and that exist, or ``None`` when the
    checkout has no manifest."""
    path = os.path.join(root, BENCHMARK_JSON)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return []
    names: list = []

    def walk(x):
        if isinstance(x, str):
            names.extend(_PY_RE.findall(x))
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(k)
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(doc)
    return sorted({os.path.normpath(n) for n in names
                   if os.path.isfile(os.path.join(root, n))})


def skipped(root: str | None = None) -> list:
    """Rules that had nothing to read on this checkout, with the
    reason: ``[{"rule": ..., "reason": ...}]``."""
    from horovod_tpu_torch.analysis import repo_root

    if bench_scripts(root or repo_root()) is not None:
        return []
    return [{"rule": "KNOB-BENCH-DRIFT",
             "reason": f"the checkout has no {BENCHMARK_JSON}, so no bench "
                       "script to read; the rule reads the scripts it "
                       "names once the port's benchmark lands"}]


def bench_drift(root: str, env_to_name: dict) -> list:
    """KNOB-BENCH-DRIFT over the bench scripts ``root``'s
    :data:`BENCHMARK_JSON` names (nothing without a manifest:
    :func:`skipped` reports that)."""
    scripts = bench_scripts(root)
    if scripts is None:
        return []
    if not scripts:
        return [_f("KNOB-BENCH-DRIFT", BENCHMARK_JSON,
                   f"{BENCHMARK_JSON} names no bench script that exists in "
                   "the checkout, so the rule has nothing to read",
                   "name the harness's .py path in the manifest")]
    findings = []
    for rel in scripts:
        with open(os.path.join(root, rel)) as f:
            tree = ast.parse(f.read(), filename=rel)
        seen = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for env in _ENV_RE.findall(node.value):
                    seen.setdefault(env, node.lineno)
        for env, lineno in sorted(seen.items()):
            if env in env_to_name or env in COORDINATION_ENV \
                    or env.startswith(INTERNAL_PREFIXES):
                continue
            findings.append(_f(
                "KNOB-BENCH-DRIFT", f"{rel}:{lineno}",
                f"bench references {env}, which is neither a registered "
                "knob nor a known coordination/internal var — the "
                "unregistered-knob drift class",
                "register the knob in common/config.py (or add it to "
                "knob_lint's coordination set with a rationale)"))
    return findings


def _registry_rules(root: str) -> list:
    from horovod_tpu_torch.common import config as _cfg

    findings = []
    knobs = _cfg.knobs()
    knob_names = frozenset(knobs)
    env_to_name = {k.env: n for n, k in knobs.items()}
    data_plane = [f"{PACKAGE}/{m}" for m in DATA_PLANE_MODULES]

    mods = _Modules(root, [CONTROLLER_PY, AOT_CACHE_PY, LAUNCHER_PY]
                    + data_plane)

    # (2) handshake closure: every registry knob round0_cfg reads,
    # transitively through its same/cross-module helpers.
    controller = mods.by_path[CONTROLLER_PY]
    r0 = controller.funcs.get("round0_cfg")
    if r0 is None:
        findings.append(_f(
            "KNOB-HANDSHAKE-MISSING", f"{CONTROLLER_PY}:1",
            "round0_cfg() not found — the handshake agreement surface "
            "moved; update knob_lint's cross-reference"))
        return findings
    handshake = mods.config_closure([r0], knob_names) & knob_names

    # (3) data-plane reads: knobs consulted while issuing transfers.
    dp_seeds = [fi for m in data_plane for fi in mods.by_path[m].all_funcs]
    dataplane = set()
    for fi in dp_seeds:
        dataplane.update(fi.config_reads)
    for fi in dp_seeds:
        idx = mods.by_path[fi.module]
        for func_expr, const_args in fi.calls:
            callee = mods.resolve(idx, func_expr)
            if callee is not None and callee.dynamic_get:
                dataplane.update(a for a in const_args
                                 if a in knob_names)
    dataplane &= knob_names

    for name in sorted(dataplane - handshake):
        findings.append(_f(
            "KNOB-TRACE-SEMANTICS", f"{CONTROLLER_PY}:round0_cfg",
            f"knob '{name}' ({knobs[name].env}) shapes the data plane's "
            "transfers but is missing from the round-0 handshake vector "
            "— a per-rank divergence issues mismatched collectives and "
            "deadlocks instead of failing fast",
            "add it to round0_cfg() (and mark the help text), or "
            "allowlist with the reason it cannot diverge"))

    # (4) help-marker <-> handshake agreement, both directions.
    for name, k in sorted(knobs.items()):
        marked = any(m in k.help.lower() for m in HANDSHAKE_MARKERS)
        if marked and name not in handshake:
            findings.append(_f(
                "KNOB-HANDSHAKE-MISSING", f"{CONFIG_PY}:registry",
                f"knob '{name}' ({k.env}) help text claims cross-rank "
                "agreement but round0_cfg() never reads it — the "
                "handshake cannot validate it",
                "add it to round0_cfg() or drop the claim from help"))
        elif name in handshake and not marked:
            findings.append(_f(
                "KNOB-HANDSHAKE-HELP", f"{CONFIG_PY}:registry",
                f"knob '{name}' ({k.env}) is validated at the round-0 "
                "handshake but its help text does not say so — "
                "operators cannot know a divergence fails the job",
                "mention 'validated at the round-0 handshake' in help",
                severity="warning"))

    # (5) nothing the data plane memoizes across responses latches a
    # handshake knob its key cannot see.
    findings.extend(memo_findings(mods, data_plane, handshake, knobs))

    # (6) an AOT cache keys on round0_cfg by construction.
    aot = mods.by_path.get(AOT_CACHE_PY)
    if aot is None or not _calls_name(aot, "round0_cfg"):
        findings.append(_f(
            "KNOB-AOT-KEY", f"{AOT_CACHE_PY}:1",
            "the AOT executable cache does not key on "
            "controller.round0_cfg() — persisted programs and the "
            "handshake would drift apart",
            "derive the cfg component of the cache key from "
            "round0_cfg() itself"))

    # (7) launcher CLI flags come from the registry.
    launcher = mods.by_path.get(LAUNCHER_PY)
    if launcher is None or not _calls_attr(launcher, "knobs"):
        findings.append(_f(
            "KNOB-CLI-REGISTRY", f"{LAUNCHER_PY}:1",
            "the launcher parser no longer iterates config.knobs() — "
            "registered CLI flags would silently stop existing",
            "build knob flags from the registry (run/launcher.py "
            "parser loop)"))

    # (8) the port's bench scripts must not invent env names.
    findings.extend(bench_drift(root, env_to_name))

    # (9) every registered knob has a doc row.
    docs_text = _docs_corpus(root)
    for name, k in sorted(knobs.items()):
        if k.env not in docs_text:
            findings.append(_f(
                "KNOB-DOC-MISSING", "docs:" + k.env,
                f"registered knob '{name}' ({k.env}) appears in no "
                "docs/*.md — operators cannot discover it",
                "add a row to the relevant doc's knob table",
                severity="warning"))

    # (10) every registered knob has a READER: some string in the
    # package (outside config.py) or a bench script names either the
    # knob or its env var.
    referenced = _referenced_strings(root)
    for name, k in sorted(knobs.items()):
        if name not in referenced and k.env not in referenced:
            findings.append(_f(
                "KNOB-DEAD", f"{CONFIG_PY}:registry",
                f"registered knob '{name}' ({k.env}) has no reader "
                "anywhere in the package or a bench script — its CLI "
                "flag and doc row promise behavior that does not exist",
                "wire the knob up or delete the registration",
                severity="warning"))
    return findings


def _referenced_strings(root: str) -> set:
    """Every string constant in the package (minus config.py) and the
    bench scripts — the read-evidence corpus for KNOB-DEAD."""
    out: set = set()
    paths = [p for p in _package_files(os.path.join(root, PACKAGE))
             if not p.replace(os.sep, "/").endswith("common/config.py")]
    paths += [os.path.join(root, rel) for rel in bench_scripts(root) or ()]
    for path in paths:
        try:
            with open(path) as f:
                tree = ast.parse(f.read(), filename=path)
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and \
                    isinstance(node.value, str):
                out.add(node.value)
    return out


def _calls_name(idx: ModuleIndex, name: str) -> bool:
    for node in ast.walk(idx.tree):
        if isinstance(node, ast.Call):
            fn = node.func
            if (isinstance(fn, ast.Name) and fn.id == name) or \
                    (isinstance(fn, ast.Attribute) and fn.attr == name):
                return True
    return False


def _calls_attr(idx: ModuleIndex, attr: str) -> bool:
    for node in ast.walk(idx.tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == attr:
            return True
    return False


def _docs_corpus(root: str) -> str:
    chunks = []
    docdir = os.path.join(root, "docs")
    if os.path.isdir(docdir):
        for fn in sorted(os.listdir(docdir)):
            if fn.endswith(".md"):
                with open(os.path.join(docdir, fn)) as f:
                    chunks.append(f.read())
    for fn in ("README.md",):
        p = os.path.join(root, fn)
        if os.path.exists(p):
            with open(p) as f:
                chunks.append(f.read())
    return "\n".join(chunks)
