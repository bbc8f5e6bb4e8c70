"""lah-lint: AST rules for the repo's threading/wire invariants (ISSUE 6).

Every rule encodes an invariant this codebase has already been burned by
(or nearly so) — the rules are repo-specific on purpose:

- **R1**  no blocking calls inside ``async def`` bodies.  Every
  ``async def`` in this package runs on one of the process's event loops
  (``lah-client``, the server's serving loop, ``lah-metrics``,
  ``lah-avg``, ``lah-dht``); a blocking call there stalls every
  connection that loop serves.  Flagged: ``time.sleep``, subprocess
  spawns, file I/O (``open``, ``numpy.load``/``save``), serialization
  work (``pack_message``, ``wire_cast``, ``encode_wire_tensors``,
  ``WireTensors.prepare`` with a payload, ``EncodedBatch.encode``), and
  un-awaited ``.acquire()`` without a timeout.
- **R2**  no blocking future waits that can self-deadlock a loop: any
  ``.result()`` inside an ``async def``, ``<loop>.run(...)`` inside an
  ``async def``, and the ``run_coroutine_threadsafe(...).result()``
  chain anywhere — the exact shape of the jitted-client ``io_callback``
  hang (ROUND5 hazards; utils/asyncio_utils.BackgroundLoop.run carries
  the matching runtime guard).
- **R3**  per-pool fan-out constants (``MAX_CHUNKS_PER_PART`` and kin,
  pattern ``MAX_(CHUNKS|RPCS|PARTS|CALLS)_PER_*``) must be statically
  **below** every ``max_inflight`` default in the linted tree: held
  replies need all of a partition's chunk RPCs admitted concurrently or
  reduction deadlocks-until-timeout (averaging/averager.py).
- **R4**  a module that speaks the held-reply protocol (references
  ``avg_part``) must construct its pools with ``require_v2=True`` —
  held replies on v1's one-RPC-per-socket discipline starve the pool.
- **R5**  msgpack meta maps use string keys only: dict literals passed
  as ``meta`` to ``pack_message``/``pack_frames``/``rpc``/
  ``rpc_prepared`` (or to ``MSGPackSerializer.dumps``/``msgpack.packb``)
  with non-string literal keys.  Int keys round-trip fine through
  msgpack but broke the ``stats`` RPC consumers once already (PR 1).
- **R6**  no bare ``except:`` and no swallowed broad handler
  (``except Exception:`` / ``except BaseException:`` whose whole body is
  ``pass``) — a swarm that eats its own failures cannot be debugged.
- **R7**  a locally-defined coroutine called as a bare statement is
  never scheduled (``foo()`` instead of ``await foo()``) — it silently
  does nothing.

Spec-conformance rules (ISSUE 14) check the CODE against the repo DOCS,
so the docs stay a checked artifact instead of prose.  The docs are
located by walking up from each linted file to the first directory
containing ``docs/PROTOCOL.md``; when none is found (isolated temp
trees) R8–R10 skip rather than guess:

- **R8**  every wire op handled by a server-side dispatcher (a
  ``msg_type == "..."`` / ``msg_type in (...)`` comparison in a module
  that defines ``_dispatch`` or ``_serve``) must appear in a
  PROTOCOL.md op table (a row whose first cell is a backticked name
  under a ``| type | ... |`` header); and — when the linted set spans
  the full package (both ``frontdoor.py`` and ``connection_handler.py``
  present) — every documented op must be handled somewhere.  The
  ``hello`` handshake is documented in prose, not a table
  (``_R8_HANDSHAKE_OPS``).
- **R9**  every headline metric name (a string literal matching
  ``lah_[a-z0-9_]+``; dynamic-prefix literals ending ``_`` are skipped)
  must appear in the OBSERVABILITY.md catalog — either verbatim or as a
  family prefix (``lah_server_*``) plus the backticked suffix.
- **R10**  every ``sanitizer.lock(name)`` name must appear in the
  CONCURRENCY.md named-lock table with a declared ordering rank, and no
  lexically nested acquisition (``with a: ... with b:``) may contradict
  the ranks (ranks must strictly increase inward).
- **R11**  a function called from an ``@runs_on``-asserted hot path
  (dispatch/decode cores) that itself acquires a tracked lock must
  carry its own ``@runs_on`` assertion or a baselined suppression —
  thread-ownership claims must cover the whole reachable hot path, not
  just its entry point.

Wire-contract conformance rules (ISSUE 15) run the analysis/schema.py
extractor over the linted set and check the SENDER-side message
construction against the HANDLER-side parse sites — the version-skew
and shape-drift classes PR 11 could only document by hand.  They
evaluate only where both sides are visible (cross-module; lint the
package root for the real verdict):

- **R12**  every meta field a sender emits for an op must be parsed by
  at least one handler of that op (``meta["f"]`` or ``meta.get("f")``)
  — an unparsed field is dead weight on every frame or, worse, a
  misspelled one the handler silently defaults.
- **R13**  every field a handler hard-requires (subscript access) must
  be guaranteed on EVERY sender construction path for that op —
  including retry/fallback/legacy branches — or an old or partial
  client turns into a server-side KeyError.
- **R14**  feature-gated wire forms may only be emitted under their
  negotiation guard: the dict ``wire`` codec form needs a dominating
  ``pool.supports("codec")`` test (legacy string dtypes are exempt);
  ``pack_frames(..., rid=...)`` outside the rid-echo /
  ``mux.next_rid()`` / ``peek_header`` idioms tags frames v1 peers
  never negotiated.  This is the mixed-build skew class as a rule.
- **R15**  PROTOCOL.md's machine-read field rows (``| field | op |
  kind | type | gate |`` tables) must match the extracted handler IR
  exactly — field set and required/optional kind both directions — so
  wire/doc drift fails the gate like lock-rank drift does.

R12–R15 suppressions additionally REQUIRE a written reason (text after
the ``ignore[...]`` bracket, or explanatory lines in the surrounding
comment block): a wire-contract asymmetry without a recorded why is a
bug, not a baseline.

R3 (gateway extension, ISSUE 14): gateway/handoff bounded-concurrency
constants — ``MAX_*SESSIONS`` class/module ints, ``*DEFAULT_PREFILL_
CHUNK`` module ints, and integer-literal env fallbacks for
``LAH_GW_*MAX*/*PENDING*/*CHUNK*`` knobs — must also sit below every
``max_inflight`` default (each concurrent session/chunk holds an
in-flight RPC window on the shared mux).  Dynamic defaults (e.g.
admission's ``4 * max_slots``) are out of static reach and are checked
at runtime by the quiesce audits instead.

Suppressions: ``# lah-lint: ignore[R1]`` (or ``ignore[R1,R5]``) on the
finding's line, or on a standalone comment line directly above it,
baselines the finding; add a reason after the bracket.  Suppressed
findings still appear with ``--list-suppressed``.  The merged tree lints
clean: ``python -m learning_at_home_tpu_torch.tools.lah_lint`` exits 0.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Optional

RULES = {
    "R1": "blocking call inside an async function (event-loop stall)",
    "R2": "blocking future wait that can self-deadlock an event loop",
    "R3": "fan-out constant not statically below the mux in-flight limit",
    "R4": "held-reply pool constructed without require_v2=True",
    "R5": "msgpack meta dict with non-string keys",
    "R6": "bare or swallowed broad exception handler",
    "R7": "coroutine called without await (never scheduled)",
    "R8": "wire op handled in code but missing from PROTOCOL.md (or vice versa)",
    "R9": "metric name not in the OBSERVABILITY.md catalog",
    "R10": "sanitizer lock name missing from CONCURRENCY.md lock table or nested against its rank",
    "R11": "lock-acquiring function on a @runs_on hot path without its own @runs_on",
    "R12": "sender-emitted meta field no handler of that op parses",
    "R13": "handler-required meta field not guaranteed on every sender path",
    "R14": "feature-gated wire form emitted without its negotiation guard",
    "R15": "PROTOCOL.md field rows out of sync with the handler schema",
}

_SUPPRESS_RE = re.compile(r"lah-lint:\s*ignore\[([A-Z0-9,\s]+)\]")

# wire-contract suppressions must carry a written reason (see docstring)
_REASON_REQUIRED = {"R12", "R13", "R14", "R15"}

# R1 canonical blocking callables (after import-alias resolution)
_BLOCKING_CALLS = {
    "time.sleep",
    "os.system", "os.popen",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "numpy.load", "numpy.save", "numpy.savez", "numpy.savez_compressed",
    "numpy.loadtxt", "numpy.savetxt",
    "socket.create_connection",
    "requests.get", "requests.post", "requests.put", "requests.request",
}
# serialization work recognized by bare name (how this repo imports them)
_SERIALIZATION_FUNCS = {"pack_message", "wire_cast", "encode_wire_tensors"}

_FANOUT_CONST_RE = re.compile(r"^MAX_(CHUNKS|RPCS|PARTS|CALLS)_PER_[A-Z_]+$")

_META_CALLS = {  # callee tail -> positional index of the meta argument
    "pack_message": 2,
    "pack_frames": 2,
    "rpc": 2,
    "rpc_prepared": 2,
}

# R3 gateway extension: bounded-concurrency constants by NAME …
_GW_BOUND_CONST_RE = re.compile(
    r"^_?(?:MAX_(?:[A-Z0-9]+_)*SESSIONS|(?:[A-Z0-9]+_)*DEFAULT_PREFILL_CHUNK)$"
)
# … and by env knob with a static integer fallback
_GW_ENV_BOUND_RE = re.compile(r"^LAH_GW_[A-Z0-9_]*(?:MAX|PENDING|CHUNK)[A-Z0-9_]*$")

# R9: headline metric literals; names ending "_" are dynamic prefixes
# (f-string families like wire_codec_payloads_total_codec_<name>)
_METRIC_LITERAL_RE = re.compile(r"^lah_[a-z0-9_]*[a-z0-9]$")

# R8: ops documented in PROTOCOL.md prose (handshake), not in an op table
_R8_HANDSHAKE_OPS = {"hello"}

_BACKTICKED_LOCK_RE = re.compile(r"`([a-z0-9_.]+)`")


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def render(self) -> str:
        tag = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: {self.rule}{tag}: {self.message}"


def _dotted(node: ast.AST, aliases: dict) -> Optional[str]:
    """Resolve a call target to a dotted name through import aliases
    (``np.load`` -> ``numpy.load``); None when the base is dynamic."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(aliases.get(node.id, node.id))
        return ".".join(reversed(parts))
    return None


def _suppressions(source: str) -> dict[int, dict]:
    """line -> {rule-id: has_written_reason} suppressed there.  A
    suppression comment covers its own line; a comment-only line covers
    the next CODE line (comment blocks pass through — the marker may sit
    anywhere in a multi-line explanation above the finding).

    ``has_written_reason`` is True when text follows the ``ignore[...]``
    bracket, or the marker sits in a comment block with other
    explanatory comment lines; rules in ``_REASON_REQUIRED`` only
    suppress with a reason."""
    out: dict[int, dict] = {}
    lines = source.splitlines()

    def _is_comment_or_blank(idx0: int) -> bool:
        s = lines[idx0].strip() if idx0 < len(lines) else ""
        return not s or s.startswith("#")

    def _is_comment(idx0: int) -> bool:
        return (
            0 <= idx0 < len(lines) and lines[idx0].strip().startswith("#")
        )

    def _put(line: int, rules: set, reasoned: bool) -> None:
        slot = out.setdefault(line, {})
        for r in rules:
            slot[r] = slot.get(r, False) or reasoned

    try:
        tokens = tokenize.generate_tokens(io.StringIO(source).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            line = tok.start[0]
            reasoned = bool(tok.string[m.end():].strip(" \t:—–-#"))
            standalone = tok.line.strip().startswith("#")
            if standalone and not reasoned:
                # multi-line explanation: any OTHER text-bearing comment
                # line in the contiguous block counts as the reason
                for idx0 in range(line - 2, -1, -1):  # lines above
                    if not _is_comment(idx0):
                        break
                    if lines[idx0].strip().lstrip("#").strip():
                        reasoned = True
                        break
                idx0 = line  # lines below (0-based `line` IS the next line)
                while not reasoned and _is_comment(idx0):
                    if lines[idx0].strip().lstrip("#").strip():
                        reasoned = True
                    idx0 += 1
            _put(line, rules, reasoned)
            if standalone:
                nxt = line  # 1-based; lines[nxt] is the NEXT line (0-based)
                while nxt < len(lines) and _is_comment_or_blank(nxt):
                    nxt += 1
                _put(nxt + 1, rules, reasoned)
    except tokenize.TokenError:
        pass
    return out


class _ModuleFacts:
    """Per-module inputs to the cross-module rules R3/R4/R8–R10."""

    def __init__(self) -> None:
        self.fanout_consts: list[tuple[int, int, str, int]] = []  # line,col,name,val
        self.gw_bound_consts: list[tuple[int, int, str, int]] = []  # line,col,name,val
        self.inflight_defaults: list[tuple[int, int]] = []  # line,val
        self.mentions_avg_part = False
        self.pool_ctor_calls: list[tuple[int, int, str, bool]] = []  # line,col,name,has_require_v2
        self.defines_dispatch = False  # module defines _dispatch/_serve (R8)
        self.handled_ops: list[tuple[int, int, str]] = []  # line,col,op
        self.metric_literals: list[tuple[int, int, str]] = []  # line,col,name
        self.lock_names: list[tuple[int, int, str]] = []  # line,col,name
        self.lock_edges: list[tuple[int, int, str, str]] = []  # line,col,outer,inner


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []
        self.facts = _ModuleFacts()
        self.aliases: dict[str, str] = {}
        self._func_stack: list[ast.AST] = []  # enclosing function defs
        self._class_stack: list[str] = []
        self._awaited: set[int] = set()
        # names of locally-defined coroutines (module funcs and methods)
        self.async_funcs: set[str] = set()
        self.async_methods: dict[str, set] = {}

    # -- helpers ----------------------------------------------------------

    def _add(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(
            Finding(self.path, node.lineno, node.col_offset, rule, msg)
        )

    def _in_async(self) -> bool:
        return bool(self._func_stack) and isinstance(
            self._func_stack[-1], ast.AsyncFunctionDef
        )

    # -- structure --------------------------------------------------------

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.aliases[a.asname or a.name.split(".")[0]] = (
                a.name if a.asname else a.name.split(".")[0]
            )
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if a.name == "*":
                continue
            self.aliases[a.asname or a.name] = f"{node.module}.{a.name}" if node.module else a.name
        self.generic_visit(node)

    def _collect_defaults(self, node) -> None:
        # align trailing defaults with trailing args (positional part)
        pos_args = node.args.args
        pos_defaults = node.args.defaults
        pairs = list(zip(pos_args[len(pos_args) - len(pos_defaults):], pos_defaults))
        pairs += [
            (a, d)
            for a, d in zip(node.args.kwonlyargs, node.args.kw_defaults)
            if d is not None
        ]
        for arg, default in pairs:
            if (
                arg.arg == "max_inflight"
                and isinstance(default, ast.Constant)
                and isinstance(default.value, int)
            ):
                self.facts.inflight_defaults.append((node.lineno, default.value))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node.name in ("_dispatch", "_serve"):
            self.facts.defines_dispatch = True
        self._collect_defaults(node)
        self._func_stack.append(node)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        # async_funcs / async_methods are filled by lint_paths' pre-pass
        # (call sites may lexically precede the definitions they target)
        if node.name in ("_dispatch", "_serve"):
            self.facts.defines_dispatch = True
        self._collect_defaults(node)
        self._func_stack.append(node)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._func_stack.append(node)
        self.generic_visit(node)
        self._func_stack.pop()

    def visit_Assign(self, node: ast.Assign) -> None:
        self._check_fanout_const(node.targets[0] if node.targets else None, node.value, node)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        self._check_fanout_const(node.target, node.value, node)
        self.generic_visit(node)

    def _check_fanout_const(self, target, value, node) -> None:
        if (
            isinstance(target, ast.Name)
            and isinstance(value, ast.Constant)
            and isinstance(value.value, int)
        ):
            if _FANOUT_CONST_RE.match(target.id):
                self.facts.fanout_consts.append(
                    (node.lineno, node.col_offset, target.id, value.value)
                )
            elif _GW_BOUND_CONST_RE.match(target.id):
                self.facts.gw_bound_consts.append(
                    (node.lineno, node.col_offset, target.id, value.value)
                )

    def visit_Constant(self, node: ast.Constant) -> None:
        if node.value == "avg_part":
            self.facts.mentions_avg_part = True
        if (
            isinstance(node.value, str)
            and _METRIC_LITERAL_RE.match(node.value)
        ):
            self.facts.metric_literals.append(
                (node.lineno, node.col_offset, node.value)
            )
        self.generic_visit(node)

    # -- R8 facts: handled wire ops ---------------------------------------

    def visit_Compare(self, node: ast.Compare) -> None:
        left = node.left
        if isinstance(left, ast.Name) and left.id == "msg_type":
            for op, comp in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)) and (
                    isinstance(comp, ast.Constant)
                    and isinstance(comp.value, str)
                ):
                    self.facts.handled_ops.append(
                        (comp.lineno, comp.col_offset, comp.value)
                    )
                elif isinstance(op, (ast.In, ast.NotIn)) and isinstance(
                    comp, (ast.Tuple, ast.List, ast.Set)
                ):
                    for el in comp.elts:
                        if isinstance(el, ast.Constant) and isinstance(
                            el.value, str
                        ):
                            self.facts.handled_ops.append(
                                (el.lineno, el.col_offset, el.value)
                            )
        self.generic_visit(node)

    # -- R6 ---------------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if node.type is None:
            self._add(node, "R6", "bare `except:` hides every failure mode")
        else:
            names = []
            t = node.type
            for sub in t.elts if isinstance(t, ast.Tuple) else [t]:
                if isinstance(sub, ast.Name):
                    names.append(sub.id)
            if (
                any(n in ("Exception", "BaseException") for n in names)
                and len(node.body) == 1
                and isinstance(node.body[0], ast.Pass)
            ):
                self._add(
                    node, "R6",
                    "broad exception swallowed (`except "
                    f"{'/'.join(names)}: pass`) — log it or narrow the type",
                )
        self.generic_visit(node)

    # -- await bookkeeping ------------------------------------------------

    def visit_Await(self, node: ast.Await) -> None:
        self._awaited.add(id(node.value))
        self.generic_visit(node)

    # -- R7 ---------------------------------------------------------------

    def visit_Expr(self, node: ast.Expr) -> None:
        call = node.value
        if isinstance(call, ast.Call):
            fn = call.func
            if isinstance(fn, ast.Name) and fn.id in self.async_funcs:
                self._add(
                    call, "R7",
                    f"coroutine {fn.id}() called without await — it is "
                    "never scheduled",
                )
            elif (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"
                and self._class_stack
                and fn.attr in self.async_methods.get(self._class_stack[-1], ())
            ):
                self._add(
                    call, "R7",
                    f"coroutine self.{fn.attr}() called without await — it "
                    "is never scheduled",
                )
        self.generic_visit(node)

    # -- calls: R1, R2, R4, R5 -------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        dotted = _dotted(node.func, self.aliases)
        tail = dotted.split(".")[-1] if dotted else None
        awaited = id(node) in self._awaited

        # R10 facts: named tracked locks
        lock_name = _sanitizer_lock_name(node, self.aliases)
        if lock_name is not None:
            self.facts.lock_names.append(
                (node.lineno, node.col_offset, lock_name)
            )

        # R3 gateway facts: integer-literal env fallbacks for bounded-
        # concurrency knobs (dynamic defaults are out of static reach)
        if dotted == "os.environ.get" and len(node.args) >= 2:
            key, default = node.args[0], node.args[1]
            if (
                isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and _GW_ENV_BOUND_RE.match(key.value)
                and isinstance(default, ast.Constant)
                and isinstance(default.value, str)
                and default.value.isdigit()
            ):
                self.facts.gw_bound_consts.append(
                    (node.lineno, node.col_offset, key.value,
                     int(default.value))
                )

        # R4 facts: pool constructions in held-reply modules
        if tail in ("PoolRegistry", "ConnectionPool"):
            has_req = any(
                kw.arg == "require_v2"
                and isinstance(kw.value, ast.Constant)
                and kw.value.value is True
                for kw in node.keywords
            )
            self.facts.pool_ctor_calls.append(
                (node.lineno, node.col_offset, tail, has_req)
            )

        # R5: meta dict literals with non-string keys
        meta_arg = None
        if tail in _META_CALLS:
            pos = _META_CALLS[tail]
            if len(node.args) > pos:
                meta_arg = node.args[pos]
            for kw in node.keywords:
                if kw.arg == "meta":
                    meta_arg = kw.value
        elif tail in ("dumps", "packb") and dotted and (
            dotted.endswith("MSGPackSerializer.dumps")
            or dotted.endswith("msgpack.packb")
        ):
            if node.args:
                meta_arg = node.args[0]
        if meta_arg is not None:
            self._check_msgpack_keys(meta_arg)

        if self._in_async() and not awaited:
            # R2: blocking waits on the loop
            if isinstance(node.func, ast.Attribute) and node.func.attr == "result":
                self._add(
                    node, "R2",
                    "`.result()` inside an async function blocks the event "
                    "loop — and self-deadlocks when the future needs THIS "
                    "loop; await instead",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "run"
                and "loop"
                in (dotted or ast.unparse(node.func.value)).lower()
            ):
                recv = dotted or f"{ast.unparse(node.func.value)}.run"
                self._add(
                    node, "R2",
                    f"`{recv}(...)` inside an async function blocks this "
                    "loop on another loop's result — the io_callback "
                    "self-deadlock shape; await the coroutine or submit()",
                )
            # R1: blocking calls
            elif dotted in _BLOCKING_CALLS or tail in _SERIALIZATION_FUNCS:
                self._add(
                    node, "R1",
                    f"blocking call `{dotted or tail}` inside an async "
                    "function — move it to a host thread or executor",
                )
            elif isinstance(node.func, ast.Name) and node.func.id == "open":
                self._add(
                    node, "R1",
                    "file I/O (`open`) inside an async function — use an "
                    "executor",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "prepare"
                and dotted is not None
                and dotted.endswith("WireTensors.prepare")
                and node.args
            ):
                self._add(
                    node, "R1",
                    "WireTensors.prepare(tensors) inside an async function "
                    "— hot-path payloads must be prepared off-loop "
                    "(rpc_prepared contract)",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "encode"
                and dotted is not None
                and dotted.endswith("EncodedBatch.encode")
            ):
                self._add(
                    node, "R1",
                    "EncodedBatch.encode inside an async function — "
                    "quantize is O(bytes) work, encode off-loop",
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and not any(kw.arg in ("timeout", "blocking") for kw in node.keywords)
                and not node.args
            ):
                self._add(
                    node, "R1",
                    "un-awaited `.acquire()` without a timeout inside an "
                    "async function — a threading lock here parks the loop",
                )

        # R2 (anywhere): run_coroutine_threadsafe(...).result() chain
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "result"
            and isinstance(node.func.value, ast.Call)
        ):
            inner = _dotted(node.func.value.func, self.aliases)
            if inner and inner.endswith("run_coroutine_threadsafe"):
                self._add(
                    node, "R2",
                    "run_coroutine_threadsafe(...).result() — guaranteed "
                    "self-deadlock when called on the target loop's own "
                    "thread; use BackgroundLoop.run (it carries the "
                    "thread-identity guard)",
                )
        self.generic_visit(node)

    def _check_msgpack_keys(self, node: ast.AST) -> None:
        if not isinstance(node, ast.Dict):
            return
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and not isinstance(k.value, str):
                self._add(
                    k, "R5",
                    f"msgpack meta key {k.value!r} is "
                    f"{type(k.value).__name__}, not str — stats/meta maps "
                    "must use string keys (PR 1 contract)",
                )
            if isinstance(v, ast.Dict):
                self._check_msgpack_keys(v)


def _sanitizer_lock_name(node: ast.AST, aliases: dict) -> Optional[str]:
    """The name argument of a ``sanitizer.lock("...")`` call (any import
    spelling that resolves to it), else None."""
    if not isinstance(node, ast.Call):
        return None
    dotted = _dotted(node.func, aliases)
    if not dotted or not dotted.endswith("sanitizer.lock"):
        return None
    if (
        node.args
        and isinstance(node.args[0], ast.Constant)
        and isinstance(node.args[0].value, str)
    ):
        return node.args[0].value
    return None


# ---------------------------------------------------------------------------
# R8–R10 doc corpus: parsed once per docs/ directory
# ---------------------------------------------------------------------------

_DOC_CACHE: dict[str, dict] = {}


def _find_docs_dir(path: str) -> Optional[str]:
    """Walk up from a linted file to the first dir holding docs/PROTOCOL.md."""
    d = os.path.dirname(os.path.abspath(path))
    while True:
        cand = os.path.join(d, "docs")
        if os.path.isfile(os.path.join(cand, "PROTOCOL.md")):
            return cand
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent


def _doc_corpus(docs_dir: str) -> dict:
    cached = _DOC_CACHE.get(docs_dir)
    if cached is not None:
        return cached
    corpus = {
        "protocol_path": os.path.join(docs_dir, "PROTOCOL.md"),
        "concurrency_path": os.path.join(docs_dir, "CONCURRENCY.md"),
        "ops": {},  # op name -> PROTOCOL.md line of its table row
        "fields": {},  # op key -> {field: {kind, types, gate, line}} (R15)
        "metric_tokens": set(),
        "metric_families": [],
        "have_observability": False,
        "lock_ranks": {},  # lock name -> int rank
        "have_concurrency": False,
    }
    # PROTOCOL.md op tables: rows whose first cell is a backticked name,
    # under a table header whose first cell is "type".  Field tables
    # (R15) use a "field" first header cell: | field | op | kind | type
    # | gate |; the op cell holds `op`, `op@family` or `*@family`, and a
    # literal (none) field cell declares an op with no op-specific
    # fields (registers the op key for coverage).
    try:
        with open(corpus["protocol_path"], encoding="utf-8") as fh:
            in_op_table = False
            in_field_table = False
            for lineno, raw in enumerate(fh, 1):
                s = raw.strip()
                if not s.startswith("|"):
                    in_op_table = False
                    in_field_table = False
                    continue
                cells = [c.strip() for c in s.strip("|").split("|")]
                if cells and cells[0] == "type":
                    in_op_table = True
                    continue
                if cells and cells[0] == "field":
                    in_field_table = True
                    continue
                if in_op_table and cells:
                    m = re.fullmatch(r"`([a-z][a-z0-9_]*)`", cells[0])
                    if m:
                        corpus["ops"].setdefault(m.group(1), lineno)
                if in_field_table and len(cells) >= 3:
                    mo = re.fullmatch(
                        r"`([a-z_*][a-z0-9_]*(?:@[a-z_]+)?)`", cells[1]
                    )
                    if mo is None:
                        continue
                    opkey = mo.group(1)
                    rows = corpus["fields"].setdefault(opkey, {})
                    mf = re.fullmatch(r"`([a-z_][a-z0-9_]*)`", cells[0])
                    if mf is None:
                        continue  # (none) / separator: op key registered
                    kind = (
                        "req" if cells[2].lower().startswith("req")
                        else "opt"
                    )
                    types = tuple(
                        t for t in re.findall(
                            r"[a-z]+", cells[3].split("[")[0]
                        )
                    ) if len(cells) > 3 else ()
                    gate = None
                    if len(cells) > 4:
                        mg = re.fullmatch(r"`([a-z]+)`", cells[4])
                        if mg:
                            gate = mg.group(1)
                    rows[mf.group(1)] = {
                        "kind": kind, "types": types, "gate": gate,
                        "line": lineno,
                    }
    except OSError:
        pass
    # OBSERVABILITY.md: every backticked token (label suffixes like
    # `{type=}` stripped); `lah_x_*` tokens declare family prefixes
    try:
        with open(os.path.join(docs_dir, "OBSERVABILITY.md"),
                  encoding="utf-8") as fh:
            text = fh.read()
        corpus["have_observability"] = True
        toks = {
            t.split("{")[0].strip()
            for t in re.findall(r"`([^`\n]+)`", text)
        }
        corpus["metric_tokens"] = toks
        corpus["metric_families"] = sorted(
            t[:-1] for t in toks if t.startswith("lah_") and t.endswith("_*")
        )
    except OSError:
        pass
    # CONCURRENCY.md lock table: | `name` | rank | ... | under the
    # "Lock node" header
    try:
        with open(corpus["concurrency_path"], encoding="utf-8") as fh:
            in_lock_table = False
            for raw in fh:
                s = raw.strip()
                if not s.startswith("|"):
                    in_lock_table = False
                    continue
                cells = [c.strip() for c in s.strip("|").split("|")]
                if cells and cells[0] == "Lock node":
                    in_lock_table = True
                    continue
                if in_lock_table and len(cells) >= 2:
                    try:
                        rank = int(cells[1])
                    except ValueError:
                        continue  # separator row
                    for nm in _BACKTICKED_LOCK_RE.findall(cells[0]):
                        corpus["lock_ranks"][nm] = rank
        corpus["have_concurrency"] = True
    except OSError:
        pass
    _DOC_CACHE[docs_dir] = corpus
    return corpus


def _metric_documented(name: str, corpus: dict) -> bool:
    toks = corpus["metric_tokens"]
    if name in toks:
        return True
    return any(
        name.startswith(fam) and name[len(fam):] in toks
        for fam in corpus["metric_families"]
    )


# ---------------------------------------------------------------------------
# R10/R11 structural pass: lock aliases, lexical nesting, hot-path reach
# ---------------------------------------------------------------------------


def _lock_alias_map(tree: ast.AST, aliases: dict) -> dict:
    """('attr', class, attr)/('mod', None, name) -> lock name, from
    ``self.x = sanitizer.lock("n")`` / ``x = sanitizer.lock("n")``."""
    amap: dict = {}

    def scan(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                scan(child, child.name)
                continue
            if isinstance(child, ast.Assign):
                nm = _sanitizer_lock_name(child.value, aliases)
                if nm:
                    for t in child.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            amap[("attr", cls, t.attr)] = nm
                        elif isinstance(t, ast.Name):
                            amap[("mod", None, t.id)] = nm
            scan(child, cls)

    scan(tree, None)
    return amap


def _resolve_lock_expr(
    expr: ast.AST, amap: dict, aliases: dict, cls: Optional[str]
) -> Optional[str]:
    nm = _sanitizer_lock_name(expr, aliases)
    if nm:
        return nm
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return amap.get(("attr", cls, expr.attr))
    if isinstance(expr, ast.Name):
        return amap.get(("mod", None, expr.id))
    return None


def _collect_lock_edges(
    tree: ast.AST, amap: dict, aliases: dict
) -> list[tuple[int, int, str, str]]:
    """(line, col, outer, inner) for every lexically nested acquisition
    of two resolvable tracked locks."""
    edges: list[tuple[int, int, str, str]] = []

    def walk(node: ast.AST, held: list, cls: Optional[str]) -> None:
        if isinstance(node, ast.ClassDef):
            cls = node.name
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            held = []  # a nested def does not run under the enclosing with
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                nm = _resolve_lock_expr(item.context_expr, amap, aliases, cls)
                if nm:
                    for h in held:
                        edges.append(
                            (node.lineno, node.col_offset, h, nm)
                        )
                    held = held + [nm]
            for b in node.body:
                walk(b, held, cls)
            return
        for child in ast.iter_child_nodes(node):
            walk(child, held, cls)

    walk(tree, [], None)
    return edges


def _r11_findings(
    path: str, tree: ast.AST, amap: dict, aliases: dict
) -> list[Finding]:
    """Functions called from an @runs_on-decorated function (direct
    ``self.m()`` / bare same-module calls) that acquire a tracked lock
    but carry no @runs_on of their own."""
    funcs: dict = {}  # (class, name) -> (def node, decorated?)

    def collect(node: ast.AST, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                collect(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                decorated = any(
                    "runs_on" in ast.unparse(d) for d in child.decorator_list
                )
                funcs[(cls, child.name)] = (child, decorated)
                collect(child, cls)
            else:
                collect(child, cls)

    collect(tree, None)

    def acquires(node: ast.AST, cls: Optional[str]) -> Optional[str]:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    nm = _resolve_lock_expr(
                        item.context_expr, amap, aliases, cls
                    )
                    if nm:
                        return nm
            elif (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "acquire"
            ):
                nm = _resolve_lock_expr(sub.func.value, amap, aliases, cls)
                if nm:
                    return nm
        return None

    findings: list[Finding] = []
    flagged: set = set()
    for (cls, name), (node, decorated) in funcs.items():
        if not decorated:
            continue
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = sub.func
            if (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"
            ):
                target = (cls, fn.attr)
            elif isinstance(fn, ast.Name):
                target = (None, fn.id)
            else:
                continue
            if target not in funcs or target in flagged:
                continue
            tnode, tdecorated = funcs[target]
            if tdecorated:
                continue
            lock_nm = acquires(tnode, target[0])
            if lock_nm is None:
                continue
            flagged.add(target)
            findings.append(
                Finding(
                    path, tnode.lineno, tnode.col_offset, "R11",
                    f"`{target[1]}` acquires tracked lock `{lock_nm}` and "
                    f"is called from @runs_on hot path `{name}` but carries "
                    "no @runs_on assertion — thread ownership must cover "
                    "the whole reachable hot path",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# R12–R15: wire-contract conformance (analysis/schema.py IR)
# ---------------------------------------------------------------------------


def _doc_rows_for(corpus: dict, op: str, family: str) -> Optional[dict]:
    """Merged field rows for an op: family-common ``*@family`` rows
    overlaid by the per-op rows (qualified ``op@family`` wins over the
    bare op key).  None when the docs carry no rows for the op at all —
    including no family rows and no ``(none)`` marker."""
    fields = corpus.get("fields", {})
    per_op = fields.get(f"{op}@{family}")
    if per_op is None:
        per_op = fields.get(op)
    fam = fields.get(f"*@{family}")
    if per_op is None and fam is None:
        return None
    merged = dict(fam or {})
    merged.update(per_op or {})
    return merged


def _wire_conformance_findings(py_files: list[str]) -> list[Finding]:
    from . import schema as _schema

    ir = _schema.extract(py_files)
    findings: list[Finding] = []
    if not ir.handlers and not ir.gate_candidates:
        return findings

    # R12: every sender-emitted field must be parsed by some handler of
    # the op (evaluated only when a handler of the op is in the set)
    for site in ir.senders:
        handlers = [h for h in ir.handlers if site.op in h.ops]
        if not handlers:
            continue
        accepted: set = set()
        for h in handlers:
            accepted.update(h.accepted(site.op))
        for name, fld in sorted(site.fields.items()):
            if name not in accepted:
                findings.append(
                    Finding(
                        site.path, fld.line or site.line, 0, "R12",
                        f"sender emits meta field `{name}` for op "
                        f"`{site.op}` but no handler of that op parses "
                        f"it (accepted: {sorted(accepted)})",
                    )
                )

    # R13: handler-required fields must be guaranteed on every sender
    # construction path.  For multi-family ops only fields EVERY family
    # requires are checked (a family-specific requirement cannot bind
    # senders addressing the other family).
    for op in sorted(ir.handled_ops()):
        required: Optional[set] = None
        for h in ir.handlers:
            if op not in h.ops:
                continue
            req = {
                name for name, use in h.accepted(op).items()
                if use.kind == "req"
            }
            required = req if required is None else (required & req)
        if not required:
            continue
        for site in ir.sender_sites(op):
            for name in sorted(required):
                fld = site.fields.get(name)
                if fld is None or fld.kind != "req":
                    how = (
                        "only conditionally" if fld is not None
                        else "never"
                    )
                    findings.append(
                        Finding(
                            site.path, site.line, 0, "R13",
                            f"handler of op `{op}` hard-requires meta "
                            f"field `{name}` (subscript access) but this "
                            f"construction path sets it {how}",
                        )
                    )

    # R14: ungated feature-dependent wire forms found by the extractor
    for cand in ir.gate_candidates:
        findings.append(
            Finding(
                cand.path, cand.line, cand.col, "R14",
                f"feature-gated `{cand.what}` form: {cand.detail}",
            )
        )

    # R15: handler IR vs the PROTOCOL.md machine-read field rows.  Ops
    # absent from the op tables entirely are R8's finding, not ours;
    # docs without any field tables leave the rule inert (pre-ISSUE-15
    # corpora).
    for h in ir.handlers:
        docs_dir = _find_docs_dir(h.path)
        if docs_dir is None:
            continue
        corpus = _doc_corpus(docs_dir)
        if not corpus.get("fields"):
            continue
        for op in sorted(h.ops):
            if op in _R8_HANDSHAKE_OPS or op not in corpus["ops"]:
                continue
            doc_fields = _doc_rows_for(corpus, op, h.family)
            op_line = h.op_lines.get(op, 0)
            if doc_fields is None:
                findings.append(
                    Finding(
                        h.path, op_line, 0, "R15",
                        f"op `{op}` ({h.family}) has no machine-read "
                        "field rows in PROTOCOL.md — add a | field | op "
                        "| kind | ... | row per field (or a (none) row)",
                    )
                )
                continue
            code_fields = h.accepted(op)
            for name, use in sorted(code_fields.items()):
                if name not in doc_fields:
                    findings.append(
                        Finding(
                            h.path, use.line or op_line, 0, "R15",
                            f"op `{op}` ({h.family}) parses meta field "
                            f"`{name}` but PROTOCOL.md has no field row "
                            "for it",
                        )
                    )
            sites = ir.sender_sites(op)
            for name, row in sorted(doc_fields.items()):
                use = code_fields.get(name)
                if use is None:
                    findings.append(
                        Finding(
                            h.path, op_line, 0, "R15",
                            f"PROTOCOL.md documents field `{name}` for "
                            f"op `{op}` ({h.family}) but the handler "
                            "never parses it (stale row or missing "
                            "parse)",
                        )
                    )
                    continue
                if use.kind == "req" and row["kind"] != "req":
                    findings.append(
                        Finding(
                            h.path, use.line or op_line, 0, "R15",
                            f"op `{op}` ({h.family}): handler "
                            f"hard-requires `{name}` but PROTOCOL.md "
                            "documents it optional",
                        )
                    )
                elif row["kind"] == "req" and use.kind != "req":
                    # a doc-required field the handler reads softly is
                    # honored when every in-set sender guarantees it (the
                    # handler validates dynamically); senderless ops
                    # trust the handler's own validation
                    if sites and any(
                        name not in s.fields
                        or s.fields[name].kind != "req"
                        for s in sites
                    ):
                        findings.append(
                            Finding(
                                h.path, use.line or op_line, 0, "R15",
                                f"op `{op}` ({h.family}): PROTOCOL.md "
                                f"documents `{name}` required but some "
                                "sender path does not guarantee it "
                                "(doc row or sender is wrong)",
                            )
                        )
    return findings


def _iter_py_files(paths: Iterable[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = [d for d in dirs if d != "__pycache__"]
                out.extend(
                    os.path.join(root, f) for f in files if f.endswith(".py")
                )
        elif p.endswith(".py"):
            out.append(p)
    return sorted(out)


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    """Lint files/directories; returns ALL findings with ``suppressed``
    set for baselined ones.  Cross-module rules (R3, R4) are evaluated
    over the whole linted set, so lint the package root for the real
    verdict."""
    findings: list[Finding] = []
    all_facts: list[tuple[str, _ModuleFacts]] = []
    suppress_by_path: dict[str, dict[int, dict]] = {}
    py_files = _iter_py_files(paths)
    for path in py_files:
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            findings.append(
                Finding(path, getattr(e, "lineno", 0) or 0, 0, "PARSE",
                        f"could not parse: {e}")
            )
            continue
        suppress_by_path[path] = _suppressions(source)
        # pre-pass: async def names must exist before visiting call sites.
        # Scoped precisely — MODULE-LEVEL async defs only for bare-name
        # calls, and per-class direct methods for self.<m>() calls — so a
        # sync module function sharing a name with some class's coroutine
        # is never false-flagged (R7 findings fail the gate; precision
        # beats recall here)
        visitor = _Visitor(path)
        for node in tree.body:
            if isinstance(node, ast.AsyncFunctionDef):
                visitor.async_funcs.add(node.name)
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.AsyncFunctionDef):
                        visitor.async_methods.setdefault(
                            node.name, set()
                        ).add(sub.name)
        visitor.visit(tree)
        # structural pass: lock aliases feed R10 nesting edges + R11
        amap = _lock_alias_map(tree, visitor.aliases)
        visitor.facts.lock_edges = _collect_lock_edges(
            tree, amap, visitor.aliases
        )
        findings.extend(_r11_findings(path, tree, amap, visitor.aliases))
        findings.extend(visitor.findings)
        all_facts.append((path, visitor.facts))

    # R3: every fan-out constant must sit below every max_inflight default
    inflight = [
        (path, line, val)
        for path, facts in all_facts
        for line, val in facts.inflight_defaults
    ]
    if inflight:
        limit = min(v for _, _, v in inflight)
        where = next((f"{p}:{ln}" for p, ln, v in inflight if v == limit), "?")
        for path, facts in all_facts:
            for line, col, name, val in facts.fanout_consts:
                if val >= limit:
                    findings.append(
                        Finding(
                            path, line, col, "R3",
                            f"{name}={val} must be < the mux in-flight "
                            f"limit {limit} ({where}): held replies need "
                            "every chunk RPC admitted concurrently",
                        )
                    )

    # R3 gateway extension: bounded-concurrency gateway/handoff constants
    # join the same comparison (each concurrent session/chunk holds an
    # in-flight RPC window on the shared mux)
    if inflight:
        limit = min(v for _, _, v in inflight)
        where = next((f"{p}:{ln}" for p, ln, v in inflight if v == limit), "?")
        for path, facts in all_facts:
            for line, col, name, val in facts.gw_bound_consts:
                if val >= limit:
                    findings.append(
                        Finding(
                            path, line, col, "R3",
                            f"{name}={val} must be < the mux in-flight "
                            f"limit {limit} ({where}): every concurrent "
                            "gateway session/chunk holds an in-flight RPC "
                            "window",
                        )
                    )

    # R4: held-reply modules must pin require_v2=True on their pools
    for path, facts in all_facts:
        if not facts.mentions_avg_part:
            continue
        for line, col, name, has_req in facts.pool_ctor_calls:
            if not has_req:
                findings.append(
                    Finding(
                        path, line, col, "R4",
                        f"{name}(...) in a held-reply (avg_part) module "
                        "without require_v2=True — held replies starve "
                        "v1's one-RPC-per-socket pool",
                    )
                )

    # R8–R10: spec conformance against the repo docs.  Docs are located
    # per linted file (so the corpus under tests/ resolves the real
    # repo docs); files with no docs in reach skip these rules.
    handled_ops_all: set = set(_R8_HANDSHAKE_OPS)
    for _, facts in all_facts:
        handled_ops_all.update(op for _, _, op in facts.handled_ops)
    basenames = {os.path.basename(p) for p, _ in all_facts}
    reverse_r8_docs: Optional[dict] = None
    for path, facts in all_facts:
        docs_dir = _find_docs_dir(path)
        if docs_dir is None:
            continue
        corpus = _doc_corpus(docs_dir)
        if facts.defines_dispatch and corpus["ops"]:
            if os.path.basename(path) in (
                "frontdoor.py", "connection_handler.py"
            ):
                reverse_r8_docs = corpus
            for line, col, op in facts.handled_ops:
                if op not in corpus["ops"] and op not in _R8_HANDSHAKE_OPS:
                    findings.append(
                        Finding(
                            path, line, col, "R8",
                            f"handled op `{op}` is not documented in any "
                            f"PROTOCOL.md op table "
                            f"({corpus['protocol_path']})",
                        )
                    )
        if corpus["have_observability"]:
            for line, col, name in facts.metric_literals:
                if not _metric_documented(name, corpus):
                    findings.append(
                        Finding(
                            path, line, col, "R9",
                            f"metric `{name}` is not in the "
                            "OBSERVABILITY.md catalog (add it verbatim or "
                            "as family prefix + suffix)",
                        )
                    )
        if corpus["have_concurrency"]:
            ranks = corpus["lock_ranks"]
            for line, col, name in facts.lock_names:
                if name not in ranks:
                    findings.append(
                        Finding(
                            path, line, col, "R10",
                            f"lock `{name}` has no row/rank in the "
                            "CONCURRENCY.md named-lock table",
                        )
                    )
            for line, col, outer, inner in facts.lock_edges:
                ra, rb = ranks.get(outer), ranks.get(inner)
                if ra is not None and rb is not None and ra >= rb:
                    findings.append(
                        Finding(
                            path, line, col, "R10",
                            f"lock `{inner}` (rank {rb}) acquired while "
                            f"holding `{outer}` (rank {ra}) — ranks must "
                            "strictly increase inward "
                            "(docs/CONCURRENCY.md lock table)",
                        )
                    )
    # R8 reverse direction: only meaningful when the linted set spans the
    # full package (both dispatcher families present)
    if (
        reverse_r8_docs is not None
        and {"frontdoor.py", "connection_handler.py"} <= basenames
    ):
        for op, doc_line in sorted(reverse_r8_docs["ops"].items()):
            if op not in handled_ops_all:
                findings.append(
                    Finding(
                        reverse_r8_docs["protocol_path"], doc_line, 0, "R8",
                        f"documented op `{op}` has no handler in the "
                        "linted set (stale PROTOCOL.md row or missing "
                        "dispatch arm)",
                    )
                )

    # R12–R15: wire-contract conformance over the schema IR (both sides
    # must be in the linted set; doc-less trees skip R15 like R8–R10)
    findings.extend(_wire_conformance_findings(py_files))

    # apply suppressions (R12–R15 demand a written reason — see
    # _suppressions; an unreasoned marker does not baseline them)
    for f in findings:
        rules = suppress_by_path.get(f.path, {}).get(f.line, {})
        if f.rule in rules:
            if f.rule in _REASON_REQUIRED and not rules[f.rule]:
                f.message += (
                    " [suppression present but carries no written "
                    "reason — wire-contract baselines must say why]"
                )
            else:
                f.suppressed = True
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def format_findings(findings: list[Finding], show_suppressed: bool = False) -> str:
    lines = [
        f.render()
        for f in findings
        if show_suppressed or not f.suppressed
    ]
    active = sum(1 for f in findings if not f.suppressed)
    sup = len(findings) - active
    lines.append(
        f"lah-lint: {active} finding(s), {sup} suppressed"
    )
    return "\n".join(lines)
