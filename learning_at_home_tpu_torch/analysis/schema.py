"""lah-schema: AST extraction of the wire contract from BOTH sides (ISSUE 15).

The swarm's trust boundary is the framed tensor RPC: four dispatcher
families (expert ``connection_handler._dispatch``, gateway
``frontdoor._dispatch``, averaging ``handler._dispatch``, DHT
``protocol._serve``) parse peer-supplied meta maps, and a dozen client
construction sites emit them — across protocol v1/v2 framing and the
negotiated ``mux``/``codec`` features.  R8 checks op *names* against
PROTOCOL.md; nothing checked message *shapes* until this module.

This is a pure-AST extractor (no imports of the linted code, sub-second,
same contract as analysis/lint.py).  It recovers a per-op wire IR:

- **handler side** — for every op branch of a dispatch function
  (``msg_type == "op"`` / ``msg_type in (...)`` arms), the meta fields
  the handler parses: ``meta["k"]`` subscripts are *required* (``req``),
  ``meta.get("k")`` reads are *accepted* (``opt``); accesses before the
  branch chain are family-common.  Helpers the meta dict is forwarded to
  (``_on_join(meta)``, ``_gen_submit(meta)``, ``handoff.handle_part(meta,
  tensors)``) are followed transitively, across modules, so the parse
  site's true field set is recovered even when validation lives in a
  different file (server/lifecycle.py).  Value types are inferred from
  ``isinstance``/cast patterns on the fetched names where visible.

- **sender side** — every ``pool.rpc``/``pool.rpc_prepared`` call whose
  op resolves to a string literal, directly or through wrapper chains
  (``GatewayClient._rpc`` -> ``pool.rpc``; ``DHTProtocol._call`` ->
  ``_transport`` -> ``pool.rpc``; ``RemoteExpert._call_blocking`` ->
  ``_rpc``/``_rpc_prepared``; the MoE fan-out closures whose ``msg_type``
  is an enclosing function's parameter).  Meta fields are resolved from
  dict literals, local assignments, ``{**meta, ...}`` augmentation,
  conditional ``meta["k"] = v`` writes and single-dict transformer
  helpers; a field is *guaranteed* when no ``if`` dominates its
  construction that does not also dominate the emit call, *conditional*
  otherwise.  Wrapper augmentations (the DHT ``from``/``port`` stamp)
  count as guaranteed for every op routed through the wrapper.

- **feature gates** — a ``meta["wire"] = <dict codec form>`` write is
  *gated* when a dominating ``pool.supports("codec")`` test covers it;
  ``pack_frames(..., rid=...)`` emission is checked against the
  rid-echo/`next_rid` idioms (protocol v2 mux).  Ungated candidates feed
  lint rule R14 (the mixed-build version-skew class).

The IR feeds: lint rules R12-R15 (analysis/lint.py), the structure-aware
fuzzer (analysis/fuzz.py + tools/lah_fuzz.py) and the collect-gate
schema stage (tools/collect_gate.py --schema).  PROTOCOL.md's
machine-read field rows are the documentation mirror of this IR (R15).
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Optional

# dispatch-function names recognized as handler entry points (same set
# R8 keys on) and the emit-call tails recognized as client senders
_DISPATCH_NAMES = ("_dispatch", "_serve")
_EMIT_TAILS = ("rpc", "rpc_prepared")
_FRAME_PACKERS = ("pack_frames", "pack_message")

# positional index of the meta argument in emit calls (after msg_type):
# rpc(msg_type, tensors, meta), rpc_prepared(msg_type, wire, meta)
_EMIT_META_POS = 2

# ops answered inline by serving loops (never dispatch branches)
HANDSHAKE_OPS = ("hello", "hello_ok")

# family inference from handled op names — a dispatcher is classified by
# what it serves, so single-file corpora work without basename hacks
_FAMILY_MARKERS = (
    ("gateway", {"gen_submit", "gen_poll", "gen_cancel"}),
    ("averaging", {"avg_join", "avg_part", "avg_stats"}),
    ("dht", {"ping", "store", "find_node", "find_value"}),
)

_MAX_DEPTH = 4  # wrapper/helper recursion bound (cycles guarded too)


@dataclasses.dataclass
class FieldUse:
    """One meta field as seen by a handler: ``req`` (subscript access)
    or ``opt`` (``.get``), with any isinstance/cast-inferred types."""

    name: str
    kind: str  # "req" | "opt"
    line: int = 0
    types: tuple = ()

    def merge(self, other: "FieldUse") -> None:
        if other.kind == "req":
            self.kind = "req"  # any hard access makes the field required
        self.types = tuple(sorted(set(self.types) | set(other.types)))


@dataclasses.dataclass
class SenderField:
    """One meta field at a sender construction site."""

    name: str
    kind: str  # "req" (on every path to the emit) | "opt" (conditional)
    line: int = 0
    gate: Optional[str] = None  # "codec"/"mux" when a supports() test dominates


@dataclasses.dataclass
class SenderSite:
    """One resolved (op, construction path) pair: the top call site where
    the op literal appears, plus the accumulated meta fields."""

    path: str
    line: int
    op: str
    fields: dict  # name -> SenderField
    via: str = ""  # wrapper chain, innermost first (diagnostics)


@dataclasses.dataclass
class HandlerSchema:
    """Per-dispatcher extraction result."""

    path: str
    family: str
    common: dict = dataclasses.field(default_factory=dict)  # name -> FieldUse
    ops: dict = dataclasses.field(default_factory=dict)  # op -> {name: FieldUse}
    op_lines: dict = dataclasses.field(default_factory=dict)  # op -> line

    def accepted(self, op: str) -> dict:
        out = dict(self.common)
        out.update(self.ops.get(op, {}))
        return out


@dataclasses.dataclass
class GateCandidate:
    """A feature-gated wire form emitted without a visible negotiation
    guard (R14 input): the dict ``wire`` codec form or a rid-tagged
    frame."""

    path: str
    line: int
    col: int
    what: str  # "wire" | "rid"
    detail: str


@dataclasses.dataclass
class WireIR:
    handlers: list = dataclasses.field(default_factory=list)  # [HandlerSchema]
    senders: list = dataclasses.field(default_factory=list)  # [SenderSite]
    gate_candidates: list = dataclasses.field(default_factory=list)
    unresolved: list = dataclasses.field(default_factory=list)  # (path, line, why)

    def families_handling(self, op: str) -> list:
        return sorted({h.family for h in self.handlers if op in h.ops})

    def handled_ops(self) -> set:
        out: set = set()
        for h in self.handlers:
            out.update(h.ops)
        return out

    def sender_sites(self, op: str) -> list:
        return [s for s in self.senders if s.op == op]


# ---------------------------------------------------------------------------
# module indexing: parents, functions, call sites
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _FuncRec:
    path: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    params: list  # positional param names (self/cls included)
    cls: Optional[str]  # enclosing class name, if a method
    enclosing: list  # outer function nodes, innermost last


class _Index:
    """Cross-file AST index built once per extraction."""

    def __init__(self) -> None:
        self.funcs: dict = {}  # short name -> [_FuncRec]
        self.parents: dict = {}  # id(node) -> parent node (per all trees)
        self.node_path: dict = {}  # id(node) -> file path
        self.trees: dict = {}  # path -> ast.Module

    def add_tree(self, path: str, tree: ast.Module) -> None:
        self.trees[path] = tree
        cls_stack: list = []
        func_stack: list = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                self.parents[id(child)] = node
                self.node_path[id(child)] = path
                is_cls = isinstance(child, ast.ClassDef)
                is_fn = isinstance(
                    child, (ast.FunctionDef, ast.AsyncFunctionDef)
                )
                if is_fn:
                    rec = _FuncRec(
                        path=path,
                        node=child,
                        params=[a.arg for a in child.args.args],
                        cls=cls_stack[-1] if cls_stack else None,
                        enclosing=list(func_stack),
                    )
                    self.funcs.setdefault(child.name, []).append(rec)
                if is_cls:
                    cls_stack.append(child.name)
                if is_fn:
                    func_stack.append(child)
                walk(child)
                if is_fn:
                    func_stack.pop()
                if is_cls:
                    cls_stack.pop()

        self.parents[id(tree)] = None
        self.node_path[id(tree)] = path
        walk(tree)

    def ancestors(self, node: ast.AST):
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def enclosing_funcs(self, node: ast.AST) -> list:
        """Enclosing function nodes, innermost first."""
        return [
            a for a in self.ancestors(node)
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]

    def enclosing_class(self, node: ast.AST) -> Optional[str]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a.name
        return None

    def resolve_callee(self, call: ast.Call, from_path: str) -> list:
        """Candidate _FuncRecs for a call, preferring same-file/-class
        matches: ``self.f(...)`` binds to methods of the caller's own
        class first; bare ``f(...)`` to same-file defs first; dotted
        receivers (``self.averager._on_join``) match by tail anywhere."""
        fn = call.func
        if isinstance(fn, ast.Name):
            cands = self.funcs.get(fn.id, [])
            local = [c for c in cands if c.path == from_path]
            return local or cands
        if not isinstance(fn, ast.Attribute):
            return []
        cands = self.funcs.get(fn.attr, [])
        if isinstance(fn.value, ast.Name) and fn.value.id in ("self", "cls"):
            cls = self.enclosing_class(call)
            same = [c for c in cands if c.path == from_path and c.cls == cls]
            if same:
                return same
        return cands


# ---------------------------------------------------------------------------
# small AST helpers
# ---------------------------------------------------------------------------


def _attr_tail(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def _const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _op_literals(test: ast.AST, opvar: str) -> Optional[list]:
    """String literals a branch test compares ``opvar`` against, else
    None (not an op branch)."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        if not (isinstance(node.left, ast.Name) and node.left.id == opvar):
            continue
        out: list = []
        for op, comp in zip(node.ops, node.comparators):
            if isinstance(op, ast.Eq):
                s = _const_str(comp)
                if s is not None:
                    out.append(s)
            elif isinstance(op, ast.In) and isinstance(
                comp, (ast.Tuple, ast.List, ast.Set)
            ):
                out.extend(
                    s for s in (_const_str(e) for e in comp.elts)
                    if s is not None
                )
        if out:
            return out
    return None


def _call_positional(call: ast.Call, rec: _FuncRec, param: str) -> Optional[ast.AST]:
    """The argument expression a call binds to ``param`` of ``rec``
    (positional, adjusted for bound ``self``, or keyword); None if the
    call does not pass it."""
    try:
        idx = rec.params.index(param)
    except ValueError:
        return None
    if rec.cls is not None and isinstance(call.func, ast.Attribute):
        idx -= 1  # self is bound by the attribute receiver
    if 0 <= idx < len(call.args):
        arg = call.args[idx]
        return None if isinstance(arg, ast.Starred) else arg
    for kw in call.keywords:
        if kw.arg == param:
            return kw.value
    return None


def _supports_feature(test: ast.AST) -> Optional[str]:
    """The feature literal of a ``<x>.supports("...")`` call inside a
    branch test, else None."""
    for node in ast.walk(test):
        if (
            isinstance(node, ast.Call)
            and _attr_tail(node.func) == "supports"
            and node.args
        ):
            s = _const_str(node.args[0])
            if s is not None:
                return s
    return None


def _legacy_wire_value(node: ast.AST) -> bool:
    """True for wire values that are provably the LEGACY STRING form
    (a dtype literal or a ``wire_dtype`` attribute) — understood by all
    peers, so no codec negotiation is needed (R14 exemption)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return True
    tail = _attr_tail(node)
    return tail is not None and tail.endswith("wire_dtype")


# ---------------------------------------------------------------------------
# handler-side extraction
# ---------------------------------------------------------------------------


def _family_of(ops: set) -> str:
    for family, markers in _FAMILY_MARKERS:
        if ops & markers:
            return family
    return "expert"


def _meta_var_of_dispatch(fn: ast.AST) -> tuple:
    """(op_var, meta_var) of a dispatch function: parameters named
    ``msg_type``/``meta`` when present, else the 1st/3rd targets of a
    tuple-assign from ``unpack_message(...)``."""
    params = [a.arg for a in fn.args.args]
    opvar = "msg_type" if "msg_type" in params else None
    metavar = "meta" if "meta" in params else None
    if opvar and metavar:
        return opvar, metavar
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if (
            isinstance(tgt, ast.Tuple)
            and len(tgt.elts) == 3
            and all(isinstance(e, ast.Name) for e in tgt.elts)
            and isinstance(node.value, ast.Call)
            and _attr_tail(node.value.func) == "unpack_message"
        ):
            opvar = opvar or tgt.elts[0].id
            metavar = metavar or tgt.elts[2].id
            break
    return opvar, metavar


def _infer_types(fn: ast.AST, metavar: str) -> dict:
    """field -> set of type names, from ``v = meta.get("k")`` /
    ``meta["k"]`` assignments followed by ``isinstance(v, T)`` checks or
    ``int(v)``/``float(v)``/``str(v)`` casts in the same function."""
    var_field: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            field = _meta_field_of(node.value, metavar)
            if field is not None:
                var_field[tgt.id] = field
    types: dict = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Name) and node.func.id == "isinstance":
            if len(node.args) == 2 and isinstance(node.args[0], ast.Name):
                field = var_field.get(node.args[0].id)
                if field is None:
                    continue
                tp = node.args[1]
                names = (
                    [e for e in tp.elts] if isinstance(tp, ast.Tuple) else [tp]
                )
                for n in names:
                    t = _attr_tail(n)
                    if t:
                        types.setdefault(field, set()).add(t)
        elif isinstance(node.func, ast.Name) and node.func.id in (
            "int", "float", "str", "bytes", "bool", "list",
        ):
            if len(node.args) >= 1:
                field = _meta_field_of(node.args[0], metavar)
                if field is None and isinstance(node.args[0], ast.Name):
                    field = var_field.get(node.args[0].id)
                if field is not None:
                    types.setdefault(field, set()).add(node.func.id)
    return types


def _meta_field_of(node: ast.AST, metavar: str) -> Optional[str]:
    """The field name when ``node`` is ``meta["k"]`` or ``meta.get("k"[, d])``."""
    if (
        isinstance(node, ast.Subscript)
        and isinstance(node.value, ast.Name)
        and node.value.id == metavar
    ):
        return _const_str(node.slice)
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "get"
        and isinstance(node.func.value, ast.Name)
        and node.func.value.id == metavar
        and node.args
    ):
        return _const_str(node.args[0])
    return None


def _harvest_fields(
    index: _Index, fn: ast.AST, metavar: str, out: dict,
    depth: int, seen: set,
) -> None:
    """Collect meta field accesses within ``fn`` into ``out`` (field ->
    FieldUse), following calls that forward the meta variable."""
    if id(fn) in seen or depth > _MAX_DEPTH:
        return
    seen.add(id(fn))
    types = _infer_types(fn, metavar)
    for node in ast.walk(fn):
        field = _meta_field_of(node, metavar)
        if field is not None:
            kind = "req" if isinstance(node, ast.Subscript) else "opt"
            use = FieldUse(field, kind, node.lineno,
                           tuple(sorted(types.get(field, ()))))
            if field in out:
                out[field].merge(use)
            else:
                out[field] = use
            continue
        if isinstance(node, ast.Call):
            # meta forwarded to a helper? follow the callee's param
            passed = [
                i for i, a in enumerate(node.args)
                if isinstance(a, ast.Name) and a.id == metavar
            ]
            if not passed:
                continue
            from_path = index.node_path.get(id(node), "")
            for rec in index.resolve_callee(node, from_path)[:3]:
                idx = passed[0]
                if rec.cls is not None and isinstance(node.func, ast.Attribute):
                    idx += 1  # self bound by receiver
                if idx < len(rec.params):
                    _harvest_fields(
                        index, rec.node, rec.params[idx], out, depth + 1, seen
                    )


def _extract_handler(index: _Index, path: str, fn: ast.AST) -> Optional[HandlerSchema]:
    opvar, metavar = _meta_var_of_dispatch(fn)
    if opvar is None or metavar is None:
        return None
    # op branches: If nodes (elif arms are nested Ifs) testing the op var
    branch_of: dict = {}  # id(stmt body If) -> ops
    op_lines: dict = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            ops = _op_literals(node.test, opvar)
            if ops:
                branch_of[id(node)] = ops
                for op in ops:
                    op_lines.setdefault(op, node.lineno)
    if not op_lines:
        return None

    def owning_ops(node: ast.AST) -> Optional[list]:
        """Ops of the innermost op-branch whose BODY contains the node."""
        cur = node
        for anc in index.ancestors(node):
            if isinstance(anc, ast.If) and id(anc) in branch_of:
                in_body = any(
                    cur is s or any(cur is w for w in ast.walk(s))
                    for s in anc.body
                )
                if in_body:
                    return branch_of[id(anc)]
            if anc is fn:
                break
        return None

    common: dict = {}
    per_op: dict = {op: {} for op in op_lines}
    types = _infer_types(fn, metavar)

    # direct accesses + helper calls, attributed to their op branch
    for node in ast.walk(fn):
        field = _meta_field_of(node, metavar)
        helper_call = None
        if field is None and isinstance(node, ast.Call):
            if any(
                isinstance(a, ast.Name) and a.id == metavar
                for a in node.args
            ):
                helper_call = node
        if field is None and helper_call is None:
            continue
        ops = owning_ops(node)
        if field is not None:
            kind = "req" if isinstance(node, ast.Subscript) else "opt"
            use = FieldUse(field, kind, node.lineno,
                           tuple(sorted(types.get(field, ()))))
            targets = (
                [per_op[o] for o in ops if o in per_op]
                if ops else [common]
            )
            for tgt in targets:
                if field in tgt:
                    tgt[field].merge(use)
                else:
                    tgt[field] = dataclasses.replace(use)
        else:
            harvested: dict = {}
            idx_args = [
                i for i, a in enumerate(helper_call.args)
                if isinstance(a, ast.Name) and a.id == metavar
            ]
            for rec in index.resolve_callee(helper_call, path)[:3]:
                if rec.node is fn:
                    continue
                idx = idx_args[0]
                if rec.cls is not None and isinstance(
                    helper_call.func, ast.Attribute
                ):
                    idx += 1
                if idx < len(rec.params):
                    _harvest_fields(
                        index, rec.node, rec.params[idx], harvested, 1,
                        {id(fn)},
                    )
            targets = (
                [per_op[o] for o in ops if o in per_op]
                if ops else [common]
            )
            for tgt in targets:
                for f, use in harvested.items():
                    if f in tgt:
                        tgt[f].merge(use)
                    else:
                        tgt[f] = dataclasses.replace(use)

    family = _family_of(set(op_lines))
    return HandlerSchema(
        path=path, family=family, common=common, ops=per_op,
        op_lines=op_lines,
    )


# ---------------------------------------------------------------------------
# sender-side extraction
# ---------------------------------------------------------------------------


def _dominating_ifs(index: _Index, node: ast.AST, scope: ast.AST) -> list:
    """If ancestors of ``node`` inside ``scope`` (innermost first)."""
    if node is scope:
        return []
    out = []
    for anc in index.ancestors(node):
        if anc is scope:
            break
        if isinstance(anc, ast.If):
            out.append(anc)
    return out


def _field_entries_from_dict(
    index: _Index, d: ast.Dict, scope: ast.AST, emit: ast.AST, ir: "WireIR",
) -> tuple:
    """(entries, passthrough_names): dict-literal fields are guaranteed;
    ``**name`` unpacks are returned for upstream resolution."""
    entries: list = []
    passthrough: list = []
    for k, v in zip(d.keys, d.values):
        if k is None:
            if isinstance(v, ast.Name):
                passthrough.append(v.id)
            continue
        name = _const_str(k)
        if name is not None:
            entries.append(SenderField(name, "req", k.lineno, None))
            if name == "wire" and not _legacy_wire_value(v):
                entries[-1].gate = _gate_of(index, d, scope, emit)
                if entries[-1].gate is None:
                    ir.gate_candidates.append(
                        GateCandidate(
                            index.node_path.get(id(d), ""), k.lineno,
                            d.col_offset, "wire",
                            "dict `wire` codec form in a meta literal "
                            "without a dominating `supports(\"codec\")` "
                            "guard",
                        )
                    )
    return entries, passthrough


def _gate_of(
    index: _Index, node: ast.AST, scope: ast.AST, emit: ast.AST,
) -> Optional[str]:
    """Feature gate dominating ``node`` but not the emit call."""
    emit_ifs = {id(i) for i in _dominating_ifs(index, emit, scope)}
    for anc in _dominating_ifs(index, node, scope):
        if id(anc) in emit_ifs:
            continue
        feat = _supports_feature(anc.test)
        if feat is not None:
            return feat
    return None


def _conditional(
    index: _Index, node: ast.AST, scope: ast.AST, emit: ast.AST,
) -> bool:
    """True when an ``if`` dominates ``node`` without dominating the
    emit call — the field is then not on every construction path."""
    emit_ifs = {id(i) for i in _dominating_ifs(index, emit, scope)}
    return any(
        id(i) not in emit_ifs
        for i in _dominating_ifs(index, node, scope)
    )


@dataclasses.dataclass
class _MetaShape:
    """Resolved meta construction: concrete fields (some op-conditional)
    plus pass-through parameter names still owed by callers."""

    entries: list = dataclasses.field(default_factory=list)  # SenderField
    op_cond: list = dataclasses.field(default_factory=list)  # (op, [SenderField])
    passthrough: list = dataclasses.field(default_factory=list)  # param names


def _resolve_meta_expr(
    index: _Index, expr: ast.AST, scope: ast.AST, emit: ast.AST,
    opvar: Optional[str], ir: WireIR, depth: int = 0,
) -> _MetaShape:
    shape = _MetaShape()
    if depth > _MAX_DEPTH or expr is None:
        return shape
    if isinstance(expr, ast.Dict):
        entries, passthrough = _field_entries_from_dict(
            index, expr, scope, emit, ir
        )
        shape.entries.extend(entries)
        for nm in passthrough:
            sub = _resolve_meta_expr(
                index, ast.Name(id=nm, ctx=ast.Load()), scope, emit,
                opvar, ir, depth + 1,
            )
            # the unpack inherits the dict's own position for guards
            shape.entries.extend(sub.entries)
            shape.op_cond.extend(sub.op_cond)
            shape.passthrough.extend(sub.passthrough)
        return shape
    if isinstance(expr, ast.IfExp):
        then = _resolve_meta_expr(
            index, expr.body, scope, emit, opvar, ir, depth + 1
        )
        other = _resolve_meta_expr(
            index, expr.orelse, scope, emit, opvar, ir, depth + 1
        )
        lits = _op_literals(expr.test, opvar) if opvar else None
        if lits and len(lits) == 1:
            shape.op_cond.append((lits[0], then.entries))
            shape.op_cond.append((None, other.entries))  # every other op
        else:
            both = {e.name for e in then.entries} & {
                e.name for e in other.entries
            }
            for e in then.entries + other.entries:
                e = dataclasses.replace(e)
                if e.name not in both:
                    e.kind = "opt"
                if e.name in both and any(
                    x.name == e.name for x in shape.entries
                ):
                    continue
                shape.entries.append(e)
        shape.passthrough.extend(then.passthrough + other.passthrough)
        return shape
    if isinstance(expr, ast.Call):
        # single-meta transformer helper: fields of its dict argument
        # plus the helper's own writes to that parameter (_wire_meta)
        from_path = index.node_path.get(id(expr), "")
        for rec in index.resolve_callee(expr, from_path)[:2]:
            arg_dicts = [a for a in expr.args if isinstance(a, ast.Dict)]
            if not arg_dicts:
                continue
            sub = _resolve_meta_expr(
                index, arg_dicts[0], scope, emit, opvar, ir, depth + 1
            )
            shape.entries.extend(sub.entries)
            shape.op_cond.extend(sub.op_cond)
            shape.passthrough.extend(sub.passthrough)
            idx = expr.args.index(arg_dicts[0])
            if rec.cls is not None and isinstance(expr.func, ast.Attribute):
                idx += 1
            if idx < len(rec.params):
                # relative to the helper's own body every dominating
                # ``if`` makes the write conditional (the helper returns
                # on all paths)
                _collect_augmentations(
                    index, rec.node, rec.params[idx], rec.node,
                    shape, ir, conditional_base=True,
                )
            break
        return shape
    if isinstance(expr, ast.Name):
        # a parameter: owed by callers
        for encl in [scope] + index.enclosing_funcs(scope):
            if expr.id in [a.arg for a in encl.args.args]:
                shape.passthrough.append(expr.id)
                return shape
        # a local: resolve its assignment + subscript augmentations
        owner = None
        for encl in [scope] + index.enclosing_funcs(emit):
            for node in ast.walk(encl):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == expr.id
                ):
                    owner = encl
                    sub = _resolve_meta_expr(
                        index, node.value, encl, emit, opvar, ir, depth + 1
                    )
                    for e in sub.entries:
                        if _conditional(index, node, encl, emit):
                            e = dataclasses.replace(e, kind="opt")
                        shape.entries.append(e)
                    shape.op_cond.extend(sub.op_cond)
                    shape.passthrough.extend(sub.passthrough)
            if owner is not None:
                break
        if owner is not None:
            _collect_augmentations(
                index, owner, expr.id, emit, shape, ir,
                conditional_base=True,
            )
        return shape
    return shape


def _collect_augmentations(
    index: _Index, scope: ast.AST, name: str, emit: ast.AST,
    shape: _MetaShape, ir: WireIR, conditional_base: bool,
) -> None:
    """``name["k"] = v`` writes inside ``scope``: guaranteed when every
    dominating ``if`` also dominates the emit, conditional otherwise;
    the ``wire`` dict form records its ``supports()`` gate (R14)."""
    for node in ast.walk(scope):
        if not (
            isinstance(node, ast.Assign)
            and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Subscript)
            and isinstance(node.targets[0].value, ast.Name)
            and node.targets[0].value.id == name
        ):
            continue
        field = _const_str(node.targets[0].slice)
        if field is None:
            continue
        cond = conditional_base and _conditional(index, node, scope, emit)
        entry = SenderField(field, "opt" if cond else "req", node.lineno)
        if field == "wire" and not _legacy_wire_value(node.value):
            entry.gate = _gate_of(index, node, scope, emit)
            if entry.gate is None:
                ir.gate_candidates.append(
                    GateCandidate(
                        index.node_path.get(id(node), ""), node.lineno,
                        node.col_offset, "wire",
                        "dict `wire` codec form assigned without a "
                        "dominating `supports(\"codec\")` guard",
                    )
                )
        shape.entries.append(entry)


def _materialize(shape: _MetaShape, op: str) -> dict:
    """Final field map for one resolved op."""
    fields: dict = {}

    def put(e: SenderField) -> None:
        if e.name in fields:
            # guaranteed beats conditional when both paths write it
            if e.kind == "req":
                fields[e.name].kind = "req"
        else:
            fields[e.name] = dataclasses.replace(e)

    for e in shape.entries:
        put(e)
    matched = any(cop == op for cop, _ in shape.op_cond)
    for cop, entries in shape.op_cond:
        if cop == op or (cop is None and not matched):
            for e in entries:
                put(e)
    return fields


def _own_augmentations(index: _Index, func: ast.AST, param: str) -> list:
    """Meta fields a wrapper stamps onto a pass-through parameter before
    forwarding it: ``param = {**param, "k": v}`` re-bindings and
    ``param["k"] = v`` writes (the DHT ``from``/``port`` stamp).
    Unconditional writes count as guaranteed for every op routed through
    the wrapper."""
    out: list = []
    for node in ast.walk(func):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        cond = bool(_dominating_ifs(index, node, func))
        if (
            isinstance(tgt, ast.Name) and tgt.id == param
            and isinstance(node.value, ast.Dict)
            and any(
                k is None and isinstance(v, ast.Name) and v.id == param
                for k, v in zip(node.value.keys, node.value.values)
            )
        ):
            for k in node.value.keys:
                nm = _const_str(k) if k is not None else None
                if nm is not None:
                    out.append(
                        SenderField(nm, "opt" if cond else "req", k.lineno)
                    )
        elif (
            isinstance(tgt, ast.Subscript)
            and isinstance(tgt.value, ast.Name)
            and tgt.value.id == param
        ):
            nm = _const_str(tgt.slice)
            if nm is not None:
                out.append(
                    SenderField(nm, "opt" if cond else "req", node.lineno)
                )
    return out


def _resolve_ops_upward(
    index: _Index, func: ast.AST, op_param: str, meta_param: Optional[str],
    ir: WireIR, depth: int, seen: set,
):
    """Yield (call_site, op_literal, caller_scope, meta_expr, extras) for
    every caller chain of ``func`` that pins the op to a string literal;
    ``extras`` accumulates wrapper-stamped meta fields along the chain."""
    if depth > _MAX_DEPTH or id(func) in seen:
        return
    seen = seen | {id(func)}
    recs = [r for rs in index.funcs.values() for r in rs if r.node is func]
    if not recs:
        return
    rec = recs[0]
    own = (
        _own_augmentations(index, func, meta_param) if meta_param else []
    )
    for path, tree in index.trees.items():
        for call in ast.walk(tree):
            if not isinstance(call, ast.Call):
                continue
            if _attr_tail(call.func) != func.name:
                continue
            # same-class guard for self-calls; bare names need same file
            if isinstance(call.func, ast.Name) and path != rec.path:
                continue
            if (
                isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id in ("self", "cls")
                and rec.cls is not None
                and index.enclosing_class(call) != rec.cls
            ):
                continue
            op_arg = _call_positional(call, rec, op_param)
            if op_arg is None:
                continue
            meta_expr = (
                _call_positional(call, rec, meta_param)
                if meta_param else None
            )
            enclosing = index.enclosing_funcs(call)
            scope = enclosing[0] if enclosing else None
            lit = _const_str(op_arg)
            if lit is not None:
                yield call, lit, scope, meta_expr, list(own)
            elif isinstance(op_arg, ast.Name) and scope is not None:
                bound = None
                for encl in enclosing:
                    if op_arg.id in [a.arg for a in encl.args.args]:
                        bound = encl
                        break
                if bound is not None:
                    # caller is itself a wrapper: recurse through it.
                    # its meta param (if the meta expr is a bare param
                    # name) keeps the chain's passthrough alive
                    next_meta = None
                    if isinstance(meta_expr, ast.Name) and meta_expr.id in [
                        a.arg for a in bound.args.args
                    ]:
                        next_meta = meta_expr.id
                    for item in _resolve_ops_upward(
                        index, bound, op_arg.id, next_meta, ir,
                        depth + 1, seen,
                    ):
                        up_call, up_lit, up_scope, up_meta, up_extra = item
                        # meta resolved at the LOWEST level that builds
                        # it; a passthrough defers to the caller's expr
                        yield up_call, up_lit, up_scope, (
                            up_meta if next_meta is not None else meta_expr
                        ), list(own) + up_extra
                else:
                    ir.unresolved.append(
                        (path, call.lineno,
                         f"op argument `{op_arg.id}` of {func.name}() is "
                         "not a parameter — op unresolvable statically")
                    )


def _extract_senders(index: _Index, ir: WireIR) -> None:
    for path, tree in index.trees.items():
        for call in ast.walk(tree):
            if not isinstance(call, ast.Call):
                continue
            tail = _attr_tail(call.func)
            if tail not in _EMIT_TAILS or not call.args:
                continue
            if isinstance(call.func, ast.Name):
                continue  # bare rpc(...) defs/recursion, not pool calls
            enclosing_names = {
                f.name for f in index.enclosing_funcs(call)
            }
            if enclosing_names & set(_EMIT_TAILS):
                # the pool's own entry points delegate to each other
                # (rpc -> rpc_prepared); their callers are already the
                # emit sites — re-deriving them here only duplicates
                continue
            op_arg = call.args[0]
            meta_expr = None
            if len(call.args) > _EMIT_META_POS:
                meta_expr = call.args[_EMIT_META_POS]
            for kw in call.keywords:
                if kw.arg == "meta":
                    meta_expr = kw.value
            enclosing = index.enclosing_funcs(call)
            scope = enclosing[0] if enclosing else None
            lit = _const_str(op_arg)
            targets = []  # (top_call, op, scope, meta_expr, extras)
            if lit is not None:
                targets.append((call, lit, scope, meta_expr, []))
            elif isinstance(op_arg, ast.Name) and scope is not None:
                bound = None
                for encl in enclosing:
                    if op_arg.id in [a.arg for a in encl.args.args]:
                        bound = encl
                        break
                if bound is None:
                    ir.unresolved.append(
                        (path, call.lineno,
                         f"emit op `{op_arg.id}` is not a literal nor an "
                         "enclosing parameter")
                    )
                    continue
                next_meta = None
                if isinstance(meta_expr, ast.Name) and meta_expr.id in [
                    a.arg for a in bound.args.args
                ]:
                    next_meta = meta_expr.id
                for item in _resolve_ops_upward(
                    index, bound, op_arg.id, next_meta, ir, 1, set()
                ):
                    up_call, up_lit, up_scope, up_meta, up_extra = item
                    targets.append((
                        up_call, up_lit, up_scope,
                        up_meta if next_meta is not None else meta_expr,
                        up_extra,
                    ))
            else:
                continue
            for top_call, op, top_scope, m_expr, extras in targets:
                if top_scope is None or m_expr is None:
                    fields: dict = {}
                else:
                    opvar = (
                        op_arg.id if isinstance(op_arg, ast.Name) else None
                    )
                    shape = _resolve_meta_expr(
                        index, m_expr, top_scope, top_call, opvar, ir
                    )
                    # fields built in the EMIT scope (closures over the
                    # wrapper's op param) are resolved there too
                    if m_expr is meta_expr and scope is not None and (
                        top_scope is not scope
                    ):
                        shape2 = _resolve_meta_expr(
                            index, meta_expr, scope, call, opvar, ir
                        )
                        shape.entries.extend(shape2.entries)
                        shape.op_cond.extend(shape2.op_cond)
                    fields = _materialize(shape, op)
                for e in extras:
                    if e.name in fields:
                        if e.kind == "req":
                            fields[e.name].kind = "req"
                    else:
                        fields[e.name] = dataclasses.replace(e)
                top_path = index.node_path.get(id(top_call), path)
                ir.senders.append(
                    SenderSite(
                        path=top_path, line=top_call.lineno, op=op,
                        fields=fields, via=tail,
                    )
                )


# ---------------------------------------------------------------------------
# rid gate candidates (protocol v2 mux)
# ---------------------------------------------------------------------------


def _rid_exempt(index: _Index, value: ast.AST, scope_chain: list) -> bool:
    """True for rid values that are echo/negotiated by construction:
    the literal None, a ``rid`` parameter of an enclosing function (the
    handlers' reply echo), a name unpacked from ``peek_header(...)``
    (the mux reader echo) or assigned from ``.next_rid()`` (issued only
    on an established mux connection)."""
    if isinstance(value, ast.Constant) and value.value is None:
        return True
    if isinstance(value, ast.Call) and value.args:
        return _rid_exempt(index, value.args[0], scope_chain)  # int(rid)
    if not isinstance(value, ast.Name):
        return False
    for fn in scope_chain:
        if value.id in [a.arg for a in fn.args.args]:
            return value.id == "rid"
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                tgts = node.targets[0] if len(node.targets) == 1 else None
                names = []
                if isinstance(tgts, ast.Name):
                    names = [tgts.id]
                elif isinstance(tgts, ast.Tuple):
                    names = [
                        e.id for e in tgts.elts if isinstance(e, ast.Name)
                    ]
                if value.id not in names:
                    continue
                src = node.value
                if isinstance(src, ast.Call) and _attr_tail(src.func) in (
                    "peek_header", "next_rid",
                ):
                    return True
    return False


def _extract_rid_candidates(index: _Index, ir: WireIR) -> None:
    for path, tree in index.trees.items():
        for call in ast.walk(tree):
            if not isinstance(call, ast.Call):
                continue
            if _attr_tail(call.func) not in _FRAME_PACKERS:
                continue
            for kw in call.keywords:
                if kw.arg != "rid":
                    continue
                chain = index.enclosing_funcs(call)
                gated = any(
                    _supports_feature(i.test) == "mux"
                    for fn in chain[:1]
                    for i in _dominating_ifs(index, call, fn)
                )
                if gated or _rid_exempt(index, kw.value, chain):
                    continue
                ir.gate_candidates.append(
                    GateCandidate(
                        path, call.lineno, call.col_offset, "rid",
                        "rid-tagged frame built outside the rid-echo / "
                        "next_rid() / supports(\"mux\") idioms — v1 peers "
                        "drop unknown header keys only after a reparse",
                    )
                )


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _iter_py_files(paths: Iterable[str]) -> list:
    out: list = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                out.extend(
                    os.path.join(root, f)
                    for f in files if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def extract(paths: Iterable[str]) -> WireIR:
    """Extract the wire IR from files/directories.  Unparseable files
    are skipped (lah-lint reports them as PARSE findings)."""
    index = _Index()
    for path in _iter_py_files(paths):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError):
            continue
        index.add_tree(path, tree)
    ir = WireIR()
    for path, tree in index.trees.items():
        for node in ast.walk(tree):
            if (
                isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in _DISPATCH_NAMES
            ):
                schema = _extract_handler(index, path, node)
                if schema is not None:
                    ir.handlers.append(schema)
    _extract_senders(index, ir)
    _extract_rid_candidates(index, ir)
    ir.handlers.sort(key=lambda h: h.path)
    # multiple resolution passes over shared wrappers re-derive the same
    # site/candidate — dedupe on stable identity
    seen_sites: set = set()
    sites: list = []
    for s in sorted(
        ir.senders,
        key=lambda s: (s.path, s.line, s.op, s.via, -len(s.fields)),
    ):
        key = (s.path, s.line, s.op, s.via)
        if key in seen_sites:
            continue
        seen_sites.add(key)
        sites.append(s)
    ir.senders = sites
    seen_cands: set = set()
    cands: list = []
    for c in sorted(
        ir.gate_candidates, key=lambda c: (c.path, c.line, c.what)
    ):
        key = (c.path, c.line, c.what)
        if key not in seen_cands:
            seen_cands.add(key)
            cands.append(c)
    ir.gate_candidates = cands
    return ir


def coverage_report(paths: Iterable[str], doc_ops: dict) -> dict:
    """Per-documented-op extraction coverage (the collect-gate schema
    stage asserts this): handler schema present for EVERY op in the
    PROTOCOL.md tables (R8's denominator), sender sites present for
    every op that has an in-tree sender.  Ops with no in-tree sender are
    listed — not failed — their required fields are validated by the
    handler itself (and exercised by lah_fuzz)."""
    ir = extract(paths)
    handled = ir.handled_ops()
    report = {
        "ops": {},
        "missing_handler": [],
        "senderless": [],
        "unresolved": list(ir.unresolved),
    }
    for op in sorted(doc_ops):
        if op in HANDSHAKE_OPS:
            continue
        has_handler = op in handled
        sites = ir.sender_sites(op)
        report["ops"][op] = {
            "families": ir.families_handling(op),
            "handler": has_handler,
            "sender_sites": len(sites),
        }
        if not has_handler:
            report["missing_handler"].append(op)
        elif not sites:
            report["senderless"].append(op)
    report["ok"] = not report["missing_handler"]
    return report
