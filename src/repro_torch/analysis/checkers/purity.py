"""graph-purity: the code a captured CUDA graph replays stays pure.

Where the reference jits (``jax.jit``, ``pl.pallas_call``), the port
captures a CUDA graph (:mod:`repro_torch.graphs`) or launches its own
kernels.  A captured graph replays the device work it recorded once, so
four classes of Python are wrong in the code it captures:

* **host-branch** — a Python ``if``/``while`` on a tensor-derived value
  (the branch needs the value on the host, and the one taken at capture
  is frozen into the graph);
* **host-sync** — ``.item()``, ``.tolist()``, ``int()`` / ``float()`` /
  ``bool()`` on a tensor, ``.cpu()``, ``.numpy()``: each copies to the
  host and waits for the device, and each raises under stream capture;
* **impure-call** — reading wall-clock (``time.time`` & friends) or
  global RNG state (stdlib ``random``, legacy ``np.random.*``): the value
  is frozen into the graph and silently reused;
* **mutable-closure** — captured code reading engine shared state
  (``# guarded-by:`` annotated fields, the annotation the lock-discipline
  rule uses): the graph bakes one snapshot while the engine mutates.

**Roots.**  The port marks no root in its code: the roots are a fixed
table, :data:`ROOTS`.  For each of the reference's 24 ``jax.jit`` /
``pl.pallas_call`` roots (what ``repro.analysis``' own root finder gives
over ``src/repro``) it names the port's counterparts — Python functions
(``module:qualname``) or, for a Pallas body, the CUDA C++ kernel in
``csrc/`` (``csrc/<file>.cu:<function>``: not Python, so not scanned, but
it must be there).  The functions the port really captures are among
them: ``DeployedCapsNet._forward_body`` (the compiled forward, a graph
per input shape), ``ServeEngine._tick_body`` (the dense family's staged
decode tick, dense caches or paged) and ``kernels.registry``'s
``fused_sampling_rows`` (the device half of sampling that tick
launches).  A row that no longer resolves is itself an error
(**missing-root**), so the table cannot rot silently.  A Python root is
checked when its module is scanned; a root whose module is missing is
reported only when the scan holds the whole package (its
``__init__.py``).

**Taint.**  At each Python root the tensor parameters are tainted: those
without an annotation, or whose annotation names ``Tensor`` or ``Any``,
except the row's ``host`` names.  Taint propagates through assignments;
tensor metadata (``x.shape``, ``x.dtype``, ``x.device``, ``x.dim()``,
``x.data_ptr()`` ...), identity tests (``x is None``) and calls of a def
whose return annotation names no tensor are host data and untaint.  host-branch and the
casts of host-sync are reported where a tainted value reaches them.

**Reachability**, as the reference's: calls are chased through
same-module defs, package imports and ``self.`` methods; every reachable
function is scanned for impure calls, the sync methods and
mutable-closure.  Dynamic dispatch (a method on a registry *instance*, an
autograd ``Function.apply``, higher-order callables) ends the chase.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple, Union

from repro_torch.analysis.checkers.locks import (_resolve_base,
                                                 class_guarded_fields)
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.loader import Module, Project

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda]

#: tensor attributes that are host metadata
UNTAINT_ATTRS = frozenset({"shape", "dtype", "ndim", "device", "is_cuda",
                           "is_meta", "requires_grad", "layout", "itemsize"})
#: tensor methods whose result is host metadata (no device read)
UNTAINT_METHODS = frozenset({"dim", "size", "numel", "nelement",
                             "element_size", "is_contiguous", "get_device",
                             "data_ptr", "stride", "storage_offset",
                             "is_floating_point"})
#: builtins whose result is never a tensor
UNTAINT_CALLS = frozenset({"len", "isinstance", "hasattr", "getattr",
                           "type", "repr", "str", "id"})
CAST_CALLS = frozenset({"int", "float", "bool", "complex"})
#: methods that copy a tensor to the host
SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
CLOCK_FUNCS = frozenset({"time", "perf_counter", "monotonic",
                         "process_time", "time_ns", "perf_counter_ns",
                         "monotonic_ns"})
_TENSOR_ANNOTATION = re.compile(r"\b(Tensor|Any)\b")


@dataclasses.dataclass(frozen=True)
class Root:
    """One reference root and the port's counterparts of it.

    ``reference`` is ``"<src/repro path>:<line> <symbol>"`` as the
    reference's root finder names it; each target is ``module:qualname``
    (a Python function) or ``csrc/<file>.cu:<function>`` (a CUDA kernel);
    ``host`` names unannotated parameters that are host values (the
    counterpart of the reference's static arguments)."""

    reference: str
    targets: Tuple[str, ...]
    host: Tuple[str, ...] = ()


_ENGINE = "repro_torch.serving.engine:ServeEngine"
_ATTN = "repro_torch.kernels.attention.kernel"
_FLASH_CU = ("csrc/flash_attention.cu:flash_attention_kernel",
             "csrc/flash_attention.cu:flash_attention_kernel_tc")
_DECODE_CU = ("csrc/decode_attention.cu:decode_attention_kernel",)

#: The reference's 24 roots and their counterparts in the port.
ROOTS: Tuple[Root, ...] = (
    Root("src/repro/deploy/pipeline.py:209 FastCapsPipeline.<lambda>",
         ("repro_torch.deploy.pipeline:DeployedCapsNet.forward",
          "repro_torch.deploy.pipeline:DeployedCapsNet._forward_body")),
    Root("src/repro/kernels/attention/kernel.py:55 _flash_kernel",
         _FLASH_CU),
    Root("src/repro/kernels/attention/kernel.py:155 _flash_dequant_kernel",
         _FLASH_CU),
    Root("src/repro/kernels/attention/kernel.py:309 _decode_kernel",
         _DECODE_CU),
    Root("src/repro/kernels/attention/kernel.py:340 _decode_dequant_kernel",
         _DECODE_CU),
    Root("src/repro/kernels/attention/kernel.py:479 kernel_with_tables",
         _DECODE_CU),
    Root("src/repro/kernels/attention/kernel.py:522 kernel_with_tables",
         _DECODE_CU),
    Root("src/repro/kernels/registry.py:244 fused_routing_entry",
         ("repro_torch.kernels.routing.routing_kernel:fused_routing_cuda",)),
    Root("src/repro/kernels/registry.py:303 taylor_softmax_entry",
         ("repro_torch.kernels.softmax.kernel:taylor_softmax_cuda",
          "repro_torch.kernels.softmax.kernel:taylor_softmax_bwd_cuda")),
    Root("src/repro/kernels/registry.py:365 flash_attention_entry",
         (f"{_ATTN}:flash_attention_cuda",)),
    Root("src/repro/kernels/registry.py:455 flash_attention_dequant_entry",
         (f"{_ATTN}:flash_attention_dequant_cuda",)),
    Root("src/repro/kernels/registry.py:565 decode_attention_entry",
         (f"{_ATTN}:decode_attention_cuda",)),
    Root("src/repro/kernels/registry.py:711 fused_sampling_entry",
         ("repro_torch.kernels.sampling.kernel:fused_sampling_cuda",
          "repro_torch.kernels.registry:fused_sampling_rows")),
    Root("src/repro/kernels/routing/routing_kernel.py:50 _routing_kernel",
         ("csrc/routing.cu:fused_routing_kernel",)),
    Root("src/repro/kernels/sampling/kernel.py:20 _fused_sampling_kernel",
         ("csrc/sampling.cu:fused_sampling_kernel",)),
    Root("src/repro/kernels/softmax/kernel.py:35 _softmax_kernel",
         ("csrc/softmax.cu:taylor_softmax_tile_kernel",
          "csrc/softmax.cu:taylor_softmax_warp_kernel",
          "csrc/softmax.cu:taylor_softmax_block_kernel")),
    Root("src/repro/launch/train.py:86 <lambda>",
         ("repro_torch.launch.train:train_capsnet.forward_classes",),
         host=("c",)),
    Root("src/repro/serving/engine.py:145 ServeEngine.<lambda>",
         (f"{_ENGINE}._decode", f"{_ENGINE}._tick_body")),
    Root("src/repro/serving/engine.py:148 ServeEngine.<lambda>",
         (f"{_ENGINE}._prefill_scatter", f"{_ENGINE}._prefill_body")),
    Root("src/repro/serving/engine.py:152 ServeEngine.<lambda>",
         ("repro_torch.models.lm:gather_cache_rows",)),
    Root("src/repro/serving/engine.py:154 ServeEngine.<lambda>",
         ("repro_torch.models.lm:scatter_cache_rows",
          f"{_ENGINE}._inject_rows.body")),
    Root("src/repro/serving/engine.py:163 ServeEngine.<lambda>",
         (f"{_ENGINE}._decode_paged_impl", f"{_ENGINE}._tick_body")),
    Root("src/repro/serving/engine.py:166 ServeEngine.<lambda>",
         (f"{_ENGINE}._prefill_paged_impl",
          f"{_ENGINE}._prefill_paged_body")),
    Root("src/repro/training/trainer.py:63 step",
         ("repro_torch.training.trainer:make_train_step.step",)),
)


@dataclasses.dataclass(frozen=True)
class _Fn:
    """One function in the call graph (module + optional class context)."""

    module: Module
    node: FuncNode
    cls: Optional[ast.ClassDef] = None

    @property
    def symbol(self) -> str:
        name = getattr(self.node, "name", "<lambda>")
        return f"{self.cls.name}.{name}" if self.cls else name

    def key(self) -> Tuple[str, str, int]:
        return (self.module.name, self.symbol, self.node.lineno)


@dataclasses.dataclass(frozen=True)
class _Root:
    fn: _Fn
    host: frozenset


class GraphPurityChecker:
    name = "graph-purity"
    description = ("functions a captured CUDA graph replays (the "
                   "port's counterparts of the reference's jit roots) "
                   "must not branch on tensors, copy them to the host, "
                   "read wall-clock/RNG globals, or close over guarded "
                   "engine state")
    codes = {
        "host-branch": "Python `if`/`while` on a tensor-derived value",
        "host-sync": ".item()/.tolist()/.cpu()/.numpy(), or "
                     "int()/float()/bool() on a tensor",
        "impure-call": "wall-clock or global-RNG read in captured code",
        "mutable-closure": "captured code reads a `# guarded-by:` engine "
                           "field",
        "missing-root": "a row of the root table resolves to nothing",
    }

    def __init__(self, roots: Tuple[Root, ...] = ROOTS):
        self._roots = roots

    def run(self, project: Project) -> Iterator[Finding]:
        roots: List[_Root] = []
        for row in self._roots:
            for target in row.targets:
                fn, missing = _resolve_target(project, target)
                if missing is not None:
                    yield missing
                elif fn is not None:
                    roots.append(_Root(fn, frozenset(row.host)))
        emitted: Set[Tuple[str, str, int]] = set()
        # pass 1: taint analysis at each root
        for root in roots:
            for f in _taint_scan(project, root):
                if self._fresh(emitted, f):
                    yield f
        # pass 2: purity scan over everything reachable from any root
        for fn in _reachable(project, [r.fn for r in roots]):
            for f in _purity_scan(project, fn):
                if self._fresh(emitted, f):
                    yield f

    @staticmethod
    def _fresh(emitted: Set[Tuple[str, str, int]], f: Finding) -> bool:
        key = (f.code, f.path, f.line)
        if key in emitted:
            return False
        emitted.add(key)
        return True


# ---------------------------------------------------------------------------
# Root resolution
# ---------------------------------------------------------------------------


def _missing(target: str, path: str, why: str) -> Finding:
    return Finding(
        rule="graph-purity", code="missing-root", path=path, line=1,
        symbol=target,
        message=f"root `{target}` of the graph-purity table {why}",
        hint="update ROOTS in repro_torch/analysis/checkers/purity.py to "
             "the function's new name or place")


def _resolve_target(project: Project, target: str
                    ) -> Tuple[Optional[_Fn], Optional[Finding]]:
    """``(function, None)`` for a resolved Python target, ``(None, None)``
    for a resolved CUDA target or one outside the scan, ``(None,
    finding)`` for a target that no longer resolves."""
    where, _, name = target.partition(":")
    if where.startswith("csrc/"):
        pkg = project.get("repro_torch")
        if pkg is None:
            return None, None
        src = pkg.path.parent / where
        if not src.exists():
            return None, _missing(target, pkg.relpath, "names no file")
        if not re.search(rf"\b{re.escape(name)}\s*\(", src.read_text()):
            return None, _missing(target, project.relpath(src),
                                  "names no kernel in its file")
        return None, None
    module = project.get(where)
    if module is None:
        pkg = project.get(where.split(".")[0])   # the package's __init__
        if pkg is None:
            return None, None
        return None, _missing(target, pkg.relpath, "names no module")
    node: ast.AST = module.tree
    cls: Optional[ast.ClassDef] = None
    for part in name.split("."):
        found = _find_def(node, part)
        if found is None:
            return None, _missing(target, module.relpath,
                                  "names no function in its module")
        if isinstance(found, ast.ClassDef):
            cls = found
        node = found
    if isinstance(node, ast.ClassDef):
        return None, _missing(target, module.relpath, "names a class")
    return _Fn(module, node, cls), None


def _find_def(node: ast.AST, name: str
              ) -> Optional[Union[ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef]]:
    """The def or class ``name`` in ``node``'s body, looking through
    ``if`` / ``with`` / ``try`` blocks but not into other defs."""
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    work = list(getattr(node, "body", []))
    while work:
        stmt = work.pop(0)
        if isinstance(stmt, defs):
            if stmt.name == name:
                return stmt
            continue
        for field in ("body", "orelse", "finalbody"):
            work.extend(getattr(stmt, field, []) or [])
        for h in getattr(stmt, "handlers", []) or []:
            work.extend(h.body)
    return None


# ---------------------------------------------------------------------------
# Taint analysis (per root, intra-procedural, nested defs inherit taint)
# ---------------------------------------------------------------------------


def _tensor_params(fn: FuncNode) -> List[str]:
    """Parameters that may hold tensors: unannotated, or annotated with a
    type that names ``Tensor`` or ``Any``."""
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    params += [p for p in (a.vararg, a.kwarg) if p is not None]
    return [p.arg for p in params
            if p.annotation is None
            or _TENSOR_ANNOTATION.search(ast.unparse(p.annotation))]


def _returns_host(project: Project, fn: _Fn, func: ast.expr) -> bool:
    """Whether ``func`` resolves to a def whose return annotation names no
    tensor (``-> str``, ``-> int``, ``-> tuple``): its result is a host
    value whatever its arguments."""
    target = _resolve_call(project, fn, func)
    if target is None or isinstance(target.node, ast.Lambda) \
            or target.node.returns is None:
        return False
    return not _TENSOR_ANNOTATION.search(ast.unparse(target.node.returns))


def _taint_scan(project: Project, root: _Root) -> Iterator[Finding]:
    module, fn = root.fn.module, root.fn.node
    findings: Dict[Tuple[str, int], Finding] = {}

    def tainted(expr: ast.expr, env: Set[str]) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in env
        if isinstance(expr, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return False              # identity is decided on the host
        if isinstance(expr, ast.Attribute):
            if expr.attr in UNTAINT_ATTRS:
                return False
            return tainted(expr.value, env)
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in UNTAINT_CALLS:
                return False
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr in UNTAINT_METHODS:
                return False
            if _returns_host(project, root.fn, expr.func):
                return False
            parts = list(expr.args) + [kw.value for kw in expr.keywords]
            if isinstance(expr.func, ast.Attribute):
                parts.append(expr.func.value)
            return any(tainted(p, env) for p in parts)
        if isinstance(expr, ast.Starred):
            return tainted(expr.value, env)
        return any(tainted(c, env) for c in ast.iter_child_nodes(expr)
                   if isinstance(c, ast.expr))

    def report(code: str, node: ast.AST, message: str, hint: str) -> None:
        findings[(code, node.lineno)] = Finding(
            rule="graph-purity", code=code, path=module.relpath,
            line=node.lineno, symbol=root.fn.symbol, message=message,
            hint=hint)

    def check_exprs(stmt: ast.stmt, env: Set[str]) -> None:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not stmt:
                continue              # nested defs handled with their own env
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name) \
                    and node.func.id in CAST_CALLS \
                    and any(tainted(a, env) for a in node.args):
                report("host-sync", node,
                       f"`{node.func.id}()` applied to a tensor-derived "
                       f"value in captured code",
                       "keep the value on the device, or pass it in as a "
                       "host argument")

    def exec_body(body: List[ast.stmt], env: Set[str]) -> None:
        for _ in range(2):            # two passes: loop-carried taint
            for stmt in body:
                exec_stmt(stmt, env)

    def exec_stmt(stmt: ast.stmt, env: Set[str]) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = set(env) | set(_tensor_params(stmt)) - {"self"}
            exec_body(stmt.body, inner)
            return
        check_exprs(stmt, env)
        for node in ast.walk(stmt):
            if isinstance(node, ast.Lambda):
                inner = set(env) | {p.arg for p in node.args.args}
                check_exprs(ast.Expr(value=node.body, lineno=node.lineno,
                                     col_offset=0), inner)
        if isinstance(stmt, ast.Assign):
            if tainted(stmt.value, env):
                for t in stmt.targets:
                    _taint_target(t, env)
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if tainted(stmt.value, env):
                _taint_target(stmt.target, env)
        elif isinstance(stmt, ast.AugAssign):
            if tainted(stmt.value, env):
                _taint_target(stmt.target, env)
        elif isinstance(stmt, (ast.If, ast.While)):
            if tainted(stmt.test, env):
                kind = "if" if isinstance(stmt, ast.If) else "while"
                report("host-branch", stmt,
                       f"Python `{kind}` branches on a tensor-derived "
                       f"value in captured code",
                       "use torch.where or a device-side mask, or decide "
                       "on host values before the captured region")
            exec_body(stmt.body, env)
            exec_body(stmt.orelse, env)
        elif isinstance(stmt, ast.For):
            if tainted(stmt.iter, env):
                _taint_target(stmt.target, env)
            exec_body(stmt.body, env)
            exec_body(stmt.orelse, env)
        elif isinstance(stmt, (ast.With, ast.Try)):
            for field in ("body", "orelse", "finalbody"):
                exec_body(getattr(stmt, field, []) or [], env)
            for h in getattr(stmt, "handlers", []) or []:
                exec_body(h.body, env)

    def _taint_target(t: ast.expr, env: Set[str]) -> None:
        if isinstance(t, ast.Name):
            env.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                _taint_target(e, env)
        elif isinstance(t, ast.Starred):
            _taint_target(t.value, env)

    env = set(_tensor_params(fn)) - root.host - {"self"}
    exec_body(fn.body, env)
    yield from findings.values()


# ---------------------------------------------------------------------------
# Reachability + purity scan
# ---------------------------------------------------------------------------


def _body(fn: _Fn) -> List[ast.stmt]:
    return fn.node.body if isinstance(fn.node.body, list) \
        else [ast.Expr(value=fn.node.body, lineno=fn.node.lineno,
                       col_offset=0)]


def _reachable(project: Project, roots: List[_Fn]) -> List[_Fn]:
    seen: Set[Tuple[str, str, int]] = set()
    out: List[_Fn] = []
    work = list(roots)
    while work:
        fn = work.pop()
        if fn.key() in seen:
            continue
        seen.add(fn.key())
        out.append(fn)
        for stmt in _body(fn):
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    target = _resolve_call(project, fn, node.func)
                    if target is not None:
                        work.append(target)
    return out


def _top_level_def(module: Module, name: str) -> Optional[_Fn]:
    for stmt in module.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and stmt.name == name:
            return _Fn(module, stmt)
    return None


def _resolve_call(project: Project, fn: _Fn, func: ast.expr
                  ) -> Optional[_Fn]:
    module = fn.module
    if isinstance(func, ast.Name):
        # same-module top-level def, else a from-import of a function
        hit = _top_level_def(module, func.id)
        if hit is not None:
            return hit
        target = project.resolve_import(module, func.id)
        if target and target[1] is not None:
            other = project.get(target[0])
            if other:
                return _top_level_def(other, target[1])
        return None
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        if func.value.id == "self" and fn.cls is not None:
            return _resolve_method(project, module, fn.cls, func.attr)
        target = project.resolve_import(module, func.value.id)
        if target and target[1] is None:
            other = project.get(target[0])
            if other:
                return _top_level_def(other, func.attr)
    return None


def _resolve_method(project: Project, module: Module, cls: ast.ClassDef,
                    name: str) -> Optional[_Fn]:
    seen: Set[Tuple[str, str]] = set()

    def find(mod: Module, cdef: ast.ClassDef) -> Optional[_Fn]:
        if (mod.name, cdef.name) in seen:
            return None
        seen.add((mod.name, cdef.name))
        for stmt in cdef.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and stmt.name == name:
                return _Fn(mod, stmt, cdef)
        for base in cdef.bases:
            resolved = _resolve_base(project, mod, base)
            if resolved:
                hit = find(*resolved)
                if hit is not None:
                    return hit
        return None

    return find(module, cls)


def _purity_scan(project: Project, fn: _Fn) -> Iterator[Finding]:
    module = fn.module
    imports = module.imports()
    guarded = (class_guarded_fields(project, module, fn.cls)
               if fn.cls is not None else {})

    def is_module(name: str, expect: str) -> bool:
        target = imports.get(name)
        return target is not None and target == (expect, None)

    def finding(code: str, node: ast.AST, message: str, hint: str
                ) -> Finding:
        return Finding(rule="graph-purity", code=code, path=module.relpath,
                       line=node.lineno, symbol=fn.symbol, message=message,
                       hint=hint)

    for stmt in _body(fn):
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                f = node.func
                if isinstance(f.value, ast.Name):
                    if f.value.id == "time" and f.attr in CLOCK_FUNCS \
                            and is_module("time", "time"):
                        yield finding(
                            "impure-call", node,
                            f"`time.{f.attr}()` in graph-captured code — "
                            f"the clock value freezes at capture",
                            "measure outside the captured region (engine "
                            "hooks run eagerly)")
                    if f.value.id == "random" \
                            and is_module("random", "random"):
                        yield finding(
                            "impure-call", node,
                            f"stdlib `random.{f.attr}()` in graph-captured "
                            f"code — global RNG state freezes at capture",
                            "draw on the device from a seeded generator "
                            "passed in")
                elif isinstance(f.value, ast.Attribute) \
                        and f.value.attr == "random" \
                        and isinstance(f.value.value, ast.Name) \
                        and is_module(f.value.value.id, "numpy"):
                    yield finding(
                        "impure-call", node,
                        f"`np.random.{f.attr}` in graph-captured code — "
                        f"numpy RNG draws freeze at capture",
                        "draw on the device from a seeded generator "
                        "passed in")
                if f.attr in SYNC_METHODS and not node.args \
                        and not node.keywords:
                    yield finding(
                        "host-sync", node,
                        f"`.{f.attr}()` in graph-captured code — copies "
                        f"to the host, waits for the device, and raises "
                        f"under stream capture",
                        "keep the value on the device, or hoist the read "
                        "out of the captured path")
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "self" \
                    and isinstance(node.ctx, ast.Load) \
                    and node.attr in guarded:
                yield finding(
                    "mutable-closure", node,
                    f"graph-captured method reads `self.{node.attr}` (a "
                    f"`# guarded-by: {guarded[node.attr]}` field) — the "
                    f"graph bakes one snapshot of shared engine state",
                    "pass the state in as a device buffer the graph reads "
                    "instead of closing over it")
