"""Concurrency-order auditor of the port (counterpart of
``horovod_tpu/analysis/concurrency_lint.py``, rule family ``CONC-*``).

Builds a lock-acquisition graph from the AST of the port's
``runtime/``, ``run/`` and ``common/`` — ``with``-blocks and
``acquire()`` calls on attributes/module globals assigned from
``threading.Lock/RLock`` — and reports the three bug classes the abort
path has shipped:

* ``CONC-LOCK-ORDER`` — a cycle in the acquisition graph (A held
  while taking B somewhere, B held while taking A elsewhere), or a
  non-reentrant ``Lock`` re-acquired on a path that already holds it.
* ``CONC-SIGNAL-LOCK`` — a plain ``Lock`` acquired on any path
  reachable from a ``signal.signal``-registered handler (the port's:
  ``runtime/flight.py``'s fatal-signal dump, ``runtime/preemption.py``'s
  drain, ``run/launcher.py``'s forwarding).  The handler runs on the
  main thread between bytecodes; a non-reentrant lock it shares with
  the interrupted critical section self-deadlocks.
* ``CONC-BLOCKING-UNDER-LOCK`` — a blocking KV/wire/sleep call made
  while one of the declared hot-path locks is held (the metrics
  registry and flight-ring contract: one mutex + a dict/slot write,
  no syscalls).

Calls are resolved for ``self.method()``, module-level functions,
``module_alias.func()`` and — where exactly one class of the module
defines the method — a method call on another object.  The port
deviates from the reference in that last fallback: a call on an
attribute of ``self`` (``self.executor.barrier()``) never resolves to a
method of the caller's own class, since the receiver is another object
(the reference resolves ``BackgroundRuntime.barrier``'s call to the
executor's ``barrier()`` back to itself and reports a self-deadlock on
``_exec_lock`` that cannot happen).  Locks reached through arbitrary
objects stay out of scope (docs/analysis.md).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from fnmatch import fnmatch

from horovod_tpu_torch.analysis.findings import Finding

#: Call names (terminal attribute or function name) that block on IO,
#: the wire, or the clock.
BLOCKING_CALLS = frozenset({
    "get_blocking", "urlopen", "sleep", "recv", "recv_into", "sendall",
    "connect", "accept", "select", "check_output", "check_call",
    "Popen", "getaddrinfo", "create_connection",
})

#: Hot-path locks (module glob, class glob, attr): the increment/record
#: contract says one mutex + memory writes, nothing that can block.
HOT_LOCKS = (
    ("horovod_tpu_torch/runtime/flight.py", "FlightRecorder", "_lock"),
    ("horovod_tpu_torch/runtime/metrics.py", "*", "_lock"),
    ("horovod_tpu_torch/runtime/background.py", "*", "_counter_lock"),
)

SCAN_DIRS = ("runtime", "run", "common")

#: Method names the unique-method fallback must never resolve: they
#: collide with builtin container/str/file methods (`self._metrics
#: .clear()` is dict.clear, not MetricsRegistry.clear).
_BUILTIN_METHODS = frozenset({
    "clear", "get", "set", "update", "pop", "popitem", "setdefault",
    "add", "remove", "discard", "append", "extend", "insert", "index",
    "count", "sort", "reverse", "copy", "keys", "values", "items",
    "join", "split", "strip", "encode", "decode", "format", "read",
    "readline", "readlines", "write", "writelines", "flush", "seek",
    "close", "open",
})


def _f(rule, loc, msg, hint="") -> Finding:
    return Finding(rule=rule, severity="error", location=loc,
                   message=msg, fix_hint=hint, pass_name="concurrency")


# ---------------------------------------------------------------------------
# Module model
# ---------------------------------------------------------------------------

LockId = tuple  # (module_relpath, class_name or "", attr_name)


@dataclass
class LockDef:
    id: LockId
    kind: str            # "Lock" | "RLock"
    line: int


@dataclass
class FuncNode:
    key: tuple                       # (module, class, name)
    node: ast.AST
    line: int
    direct: set = field(default_factory=set)       # LockIds acquired here
    plain_direct: set = field(default_factory=set)  # subset with kind Lock
    callsites: list = field(default_factory=list)  # (callee_key?, held, line)
    edges: list = field(default_factory=list)      # (held_lock, new_lock, line)
    blocking: list = field(default_factory=list)   # (held, name, line)


def _lock_ctor_kind(value) -> str | None:
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else "")
        if name in ("Lock", "RLock"):
            return name
    return None


class _ModuleScan:
    def __init__(self, relpath: str, tree: ast.AST):
        self.relpath = relpath
        self.tree = tree
        self.locks: dict = {}          # LockId -> LockDef
        self.funcs: dict = {}          # (class, name) -> FuncNode
        self.module_aliases: dict = {}  # local alias -> module name
        self.extern_aliases: set = set()  # plain `import x` names
        self.handlers: list = []       # (handler name, class, line)
        self._collect()

    def _collect(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self.module_aliases[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
            elif isinstance(node, ast.Import):
                for alias in node.names:
                    self.extern_aliases.add(
                        alias.asname or alias.name.split(".")[0])
        # module-level locks
        for node in self.tree.body:
            if isinstance(node, ast.Assign):
                kind = _lock_ctor_kind(node.value)
                if kind:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            lid = (self.relpath, "", t.id)
                            self.locks[lid] = LockDef(lid, kind,
                                                      node.lineno)
        # class attribute locks + functions
        self._walk_scope(self.tree.body, cls="")

    def _walk_scope(self, body, cls: str) -> None:
        for node in body:
            if isinstance(node, ast.ClassDef):
                self._walk_scope(node.body, cls=node.name)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                self._scan_lock_defs(node, cls)
                fn = FuncNode(key=(self.relpath, cls, node.name),
                              node=node, line=node.lineno)
                self.funcs[(cls, node.name)] = fn
                # nested defs are indexed too (signal handlers are
                # often closures)
                for sub in ast.walk(node):
                    if sub is not node and isinstance(
                            sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self.funcs.setdefault(
                            (cls, sub.name),
                            FuncNode(key=(self.relpath, cls, sub.name),
                                     node=sub, line=sub.lineno))

    def _scan_lock_defs(self, func, cls: str) -> None:
        for node in ast.walk(func):
            if isinstance(node, ast.Assign):
                kind = _lock_ctor_kind(node.value)
                if not kind:
                    continue
                for t in node.targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        lid = (self.relpath, cls, t.attr)
                        self.locks[lid] = LockDef(lid, kind, node.lineno)

    def resolve_lock(self, expr, cls: str) -> LockId | None:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name) and \
                expr.value.id == "self":
            return (self.relpath, cls, expr.attr)
        if isinstance(expr, ast.Name):
            lid = (self.relpath, "", expr.id)
            if lid in self.locks:
                return lid
        return None


# ---------------------------------------------------------------------------
# Function-body simulation
# ---------------------------------------------------------------------------


class _BodyVisitor(ast.NodeVisitor):
    def __init__(self, scan: _ModuleScan, fn: FuncNode, known: dict):
        self.scan = scan
        self.fn = fn
        self.cls = fn.key[1]
        self.known = known               # global LockId -> LockDef
        self.held: tuple = ()

    def _lock_known(self, lid) -> bool:
        return lid in self.known

    def _acquire(self, lid, line) -> None:
        for h in self.held:
            self.fn.edges.append((h, lid, line))
        self.fn.direct.add(lid)
        if self.known.get(lid) and self.known[lid].kind == "Lock":
            self.fn.plain_direct.add(lid)
        if lid in self.held:
            # re-entry in the same static scope
            self.fn.edges.append((lid, lid, line))

    def visit_With(self, node) -> None:
        acquired = []
        for item in node.items:
            self.generic_visit(item.context_expr)
            lid = self.scan.resolve_lock(item.context_expr, self.cls)
            if lid is not None and self._lock_known(lid):
                self._acquire(lid, node.lineno)
                acquired.append(lid)
        prev = self.held
        self.held = prev + tuple(acquired)
        for stmt in node.body:
            self.visit(stmt)
        self.held = prev

    visit_AsyncWith = visit_With

    def visit_Call(self, node) -> None:
        fnexpr = node.func
        # lock.acquire(): treat as held for the remainder of the
        # function (conservative; with-blocks are the dominant idiom)
        if isinstance(fnexpr, ast.Attribute) and \
                fnexpr.attr == "acquire":
            lid = self.scan.resolve_lock(fnexpr.value, self.cls)
            if lid is not None and self._lock_known(lid):
                self._acquire(lid, node.lineno)
                self.held = self.held + (lid,)
                self.generic_visit(node)
                return
        name = (fnexpr.attr if isinstance(fnexpr, ast.Attribute)
                else fnexpr.id if isinstance(fnexpr, ast.Name) else "")
        if name in BLOCKING_CALLS:
            # recorded regardless of held locks: a lock-free leaf
            # still contributes to callers' transitive blocking sets
            self.fn.blocking.append((self.held, name, node.lineno))
        if name and name not in ("acquire", "release"):
            self.fn.callsites.append((fnexpr, self.held, node.lineno))
        self.generic_visit(node)

    def visit_FunctionDef(self, node) -> None:
        if node is self.fn.node:
            self.generic_visit(node)
        # nested defs are analyzed as their own FuncNodes

    visit_AsyncFunctionDef = visit_FunctionDef


# ---------------------------------------------------------------------------
# Whole-tree analysis
# ---------------------------------------------------------------------------


class Auditor:
    def __init__(self, root: str, relpaths: list, hot_locks=HOT_LOCKS,
                 all_locks_hot: bool = False):
        self.root = root
        self.scans: dict = {}
        self.hot = hot_locks
        self.all_hot = all_locks_hot
        for rel in relpaths:
            with open(os.path.join(root, rel)) as f:
                try:
                    tree = ast.parse(f.read(), filename=rel)
                except SyntaxError:
                    continue
            self.scans[rel] = _ModuleScan(rel, tree)
        self.locks: dict = {}
        for s in self.scans.values():
            self.locks.update(s.locks)
        self.funcs: dict = {}          # (module, class, name) -> FuncNode
        for s in self.scans.values():
            for fn in s.funcs.values():
                self.funcs[fn.key] = fn
        for s in self.scans.values():
            for fn in s.funcs.values():
                _BodyVisitor(s, fn, self.locks).visit(fn.node)
        self._fixpoint()

    # -- call graph -------------------------------------------------------

    def _resolve_call(self, module: str, cls: str, fnexpr):
        scan = self.scans[module]
        if isinstance(fnexpr, ast.Name):
            if cls and (cls, fnexpr.id) in scan.funcs:
                return (module, cls, fnexpr.id)
            if ("", fnexpr.id) in scan.funcs:
                return (module, "", fnexpr.id)
        elif isinstance(fnexpr, ast.Attribute):
            if isinstance(fnexpr.value, ast.Name):
                base = fnexpr.value.id
                if base == "self" and (cls, fnexpr.attr) in scan.funcs:
                    return (module, cls, fnexpr.attr)
                target = scan.module_aliases.get(base)
                if target:
                    for rel, other in self.scans.items():
                        modname = rel.replace("/", ".") \
                            .removesuffix(".py")
                        # dotted-boundary suffix match only: "x.y"
                        # resolves "a.x.y" but never "a.bx.y"
                        if modname == target or \
                                modname.endswith("." + target):
                            if ("", fnexpr.attr) in other.funcs:
                                return (rel, "", fnexpr.attr)
            # method call on an arbitrary object (`recorder().record()`,
            # `self._ring.dump()`): when exactly one class in the SAME
            # module defines the method, resolve to it — the precision
            # that makes a signal handler's reach into
            # FlightRecorder.record visible (a plain ring lock there would
            # self-deadlock the fatal-signal dump).
            # Builtin container/file method names and attribute calls on
            # plainly-imported external modules (json.dump) are excluded
            # — those are never the class's method.
            if fnexpr.attr in _BUILTIN_METHODS:
                return None
            if isinstance(fnexpr.value, ast.Name) and \
                    fnexpr.value.id in scan.extern_aliases:
                return None
            owners = [(c, n) for (c, n) in scan.funcs
                      if n == fnexpr.attr and c != ""]
            if len(owners) == 1:
                # `self.executor.barrier()` is another object's method:
                # never the caller's own class's
                if owners[0][0] == cls and not (
                        isinstance(fnexpr.value, ast.Name)
                        and fnexpr.value.id == "self"):
                    return None
                return (module, owners[0][0], owners[0][1])
        return None

    def _fixpoint(self) -> None:
        self.trans: dict = {k: set(fn.direct)
                            for k, fn in self.funcs.items()}
        self.calls: dict = {}
        for key, fn in self.funcs.items():
            resolved = []
            for fnexpr, held, line in fn.callsites:
                callee = self._resolve_call(key[0], key[1], fnexpr)
                if callee is not None:
                    resolved.append((callee, held, line))
            self.calls[key] = resolved
        changed = True
        while changed:
            changed = False
            for key, callees in self.calls.items():
                for callee, _held, _line in callees:
                    extra = self.trans.get(callee, set()) - self.trans[key]
                    if extra:
                        self.trans[key].update(extra)
                        changed = True
        # transitive blocking set: (blocking name, module, line) per
        # function, through ANY call depth — a sendall() three frames
        # below a hot lock is the same contract violation as a direct
        # one.
        self.blocking_trans: dict = {
            k: {(name, k[0], line) for _held, name, line in fn.blocking}
            for k, fn in self.funcs.items()}
        changed = True
        while changed:
            changed = False
            for key, callees in self.calls.items():
                for callee, _held, _line in callees:
                    extra = self.blocking_trans.get(callee, set()) \
                        - self.blocking_trans[key]
                    if extra:
                        self.blocking_trans[key].update(extra)
                        changed = True

    # -- rules ------------------------------------------------------------

    def _is_hot(self, lid: LockId) -> bool:
        if self.all_hot:
            return True
        return any(fnmatch(lid[0], m) and fnmatch(lid[1] or "", c)
                   and lid[2] == a for m, c, a in self.hot)

    def _fmt(self, lid: LockId) -> str:
        mod, cls, attr = lid
        owner = f"{cls}." if cls else ""
        kind = self.locks[lid].kind if lid in self.locks else "?"
        return f"{mod}:{owner}{attr} ({kind})"

    def lock_order_findings(self) -> list:
        edges: dict = {}
        lines: dict = {}
        for key, fn in self.funcs.items():
            for a, b, line in fn.edges:
                edges.setdefault(a, set()).add(b)
                lines.setdefault((a, b), (fn.key, line))
            for callee, held, line in self.calls.get(key, []):
                for a in held:
                    for b in self.trans.get(callee, ()):
                        edges.setdefault(a, set()).add(b)
                        lines.setdefault((a, b), (fn.key, line))
        findings = []
        reported = set()
        # self-loops: re-acquiring a non-reentrant lock
        for a, succs in edges.items():
            if a in succs:
                kind = self.locks[a].kind if a in self.locks else None
                if kind == "Lock":
                    key, line = lines[(a, a)]
                    findings.append(_f(
                        "CONC-LOCK-ORDER", f"{key[0]}:{line}",
                        f"non-reentrant lock {self._fmt(a)} can be "
                        f"re-acquired on a path that already holds it "
                        f"(via {key[1] or ''}{'.' if key[1] else ''}"
                        f"{key[2]}) — self-deadlock",
                        "make it an RLock or restructure so the inner "
                        "path never re-enters"))
                    reported.add((a,))
        # multi-lock cycles (DFS)
        def dfs(node, path, onpath):
            for nxt in sorted(edges.get(node, ())):
                if nxt == node:
                    continue
                if nxt in onpath:
                    cyc = tuple(path[path.index(nxt):] + [nxt])
                    canon = tuple(sorted(set(cyc)))
                    if canon in reported:
                        continue
                    reported.add(canon)
                    where = " -> ".join(self._fmt(x) for x in cyc)
                    key, line = lines.get((node, nxt), (("?", "", "?"), 0))
                    findings.append(_f(
                        "CONC-LOCK-ORDER", f"{key[0]}:{line}",
                        f"lock-order cycle: {where} — two threads "
                        "taking these in opposite order deadlock",
                        "impose one global acquisition order (or drop "
                        "a lock from the nested region)"))
                elif len(path) < 16:
                    dfs(nxt, path + [nxt], onpath | {nxt})

        for start in sorted(edges):
            dfs(start, [start], {start})
        return findings

    def signal_roots(self) -> list:
        """Every ``signal.signal(sig, handler)`` registration whose
        handler is a function of the scanned tree or a lambda:
        ``(module, line, handler name, root function keys)``.  A
        lambda's roots are the functions its body calls (resolved in
        the registering function's class).  A handler restored from a
        saved value (``prev or SIG_DFL``) is no new root."""
        roots = []
        for rel, scan in self.scans.items():
            owner = {}
            for fn in scan.funcs.values():
                for sub in ast.walk(fn.node):
                    owner.setdefault(id(sub), fn.key[1])
            for node in ast.walk(scan.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "signal"
                        and isinstance(node.func.value, ast.Name)
                        and node.func.value.id == "signal"
                        and len(node.args) >= 2):
                    continue
                handler = node.args[1]
                if isinstance(handler, ast.Name):
                    keys = [fn.key for (cls, name), fn in scan.funcs.items()
                            if name == handler.id][:1]
                    if keys:
                        roots.append((rel, node.lineno, handler.id, keys))
                elif isinstance(handler, ast.Lambda):
                    cls = owner.get(id(node), "")
                    keys = []
                    for sub in ast.walk(handler.body):
                        if isinstance(sub, ast.Call):
                            callee = self._resolve_call(rel, cls, sub.func)
                            if callee is not None:
                                keys.append(callee)
                    roots.append((rel, node.lineno, "<lambda>", keys))
        return roots

    def signal_findings(self) -> list:
        findings = []
        for rel, line, hname, keys in self.signal_roots():
            reach = set()
            for hkey in keys:
                reach |= self._reachable(hkey)
            for fkey in sorted(reach):
                for lid in sorted(self.funcs[fkey].plain_direct):
                    findings.append(_f(
                        "CONC-SIGNAL-LOCK",
                        f"{fkey[0]}:{self.funcs[fkey].line}",
                        f"signal handler {hname} (registered "
                        f"at {rel}:{line}) can reach "
                        f"{fkey[1] or ''}{'.' if fkey[1] else ''}"
                        f"{fkey[2]}, which acquires non-reentrant "
                        f"{self._fmt(lid)} — a signal landing "
                        "inside that critical section "
                        "self-deadlocks the handler",
                        "use an RLock on every handler-reachable "
                        "path (as the flight ring's lock is)"))
        return findings

    def _reachable(self, start) -> set:
        seen, stack = set(), [start]
        while stack:
            key = stack.pop()
            if key in seen or key not in self.funcs:
                continue
            seen.add(key)
            stack.extend(c for c, _h, _l in self.calls.get(key, []))
        return seen

    def blocking_findings(self) -> list:
        findings = []
        for key, fn in self.funcs.items():
            for held, name, line in fn.blocking:
                hot = [h for h in held if self._is_hot(h)]  # may be ()
                for h in hot:
                    findings.append(_f(
                        "CONC-BLOCKING-UNDER-LOCK", f"{key[0]}:{line}",
                        f"blocking call {name}() while holding "
                        f"hot-path lock {self._fmt(h)} — the "
                        "record/increment contract is one mutex + "
                        "memory writes, no syscalls",
                        "move the blocking work outside the critical "
                        "section (snapshot under lock, IO outside)"))
            # calls whose TRANSITIVE closure blocks while a hot lock
            # is held (any depth — same fixpoint as lock acquisition)
            for callee, held, line in self.calls.get(key, []):
                hot = [h for h in held if self._is_hot(h)]
                if not hot:
                    continue
                for name, bmod, bline in sorted(
                        self.blocking_trans.get(callee, ())):
                    for h in hot:
                        findings.append(_f(
                            "CONC-BLOCKING-UNDER-LOCK",
                            f"{key[0]}:{line}",
                            f"call to {callee[2]}() under hot-path "
                            f"lock {self._fmt(h)} reaches blocking "
                            f"{name}() ({bmod}:{bline})",
                            "move the blocking work outside the "
                            "critical section"))
        return findings


def run(package_dir: str | None = None) -> list:
    """Run the audit over runtime/, run/ and common/ (or a fixture
    tree, where every lock is treated as hot so the blocking rule is
    exercisable without the real hot-lock declarations)."""
    from horovod_tpu_torch.analysis import PACKAGE, repo_root

    if package_dir is not None:
        relpaths = []
        for dirpath, dirnames, filenames in os.walk(package_dir):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    relpaths.append(os.path.relpath(
                        os.path.join(dirpath, fn), package_dir))
        auditor = Auditor(package_dir, relpaths, all_locks_hot=True)
    else:
        root = repo_root()
        relpaths = []
        for sub in SCAN_DIRS:
            base = os.path.join(root, PACKAGE, sub)
            for dirpath, dirnames, filenames in os.walk(base):
                dirnames[:] = [d for d in dirnames
                               if d not in ("__pycache__", "csrc")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        relpaths.append(os.path.relpath(
                            os.path.join(dirpath, fn), root))
        auditor = Auditor(root, relpaths)
    return (auditor.lock_order_findings() + auditor.signal_findings()
            + auditor.blocking_findings())
