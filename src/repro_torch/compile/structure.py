"""Canonical structural hashing of loop programs for the compile cache.

The compile cache (:mod:`repro_torch.compile.cache`) must reuse one compiled
artifact across every request with the *same dependence structure* — the
serving path re-plans the identical decode loop once per batch wave, and the
Pallas K-loop plan re-lowers the identical ISSUE/LOAD/COMPUTE loop for every
``steps`` value.  The key therefore covers exactly what the lowering
specializes on and nothing else:

  * the statement graph — statement names in lexical order, their write /
    read / guard accesses (array name + constant offset vector), and a
    *behavioral* fingerprint of each compute function;
  * the retained (synchronized) dependences, as an order-insensitive set;
  * the execution model (``doall`` / ``dswp`` / ``procmap`` + processor map);
  * the SCC partition of the statement graph (:func:`repro_torch.core.scc_signature`
    — membership + recurrence flags + the bounds-free unimodular-skew
    candidate per recurrence SCC), the DOACROSS ``chunk_limit`` knob, and
    the ``scc_policy`` knob — the *resolved policy object* canonicalized by
    :func:`_const_fp` with its full instance state (nested policies,
    ndarray-valued knobs by content hash), so two artifacts that condense,
    chunk, skew, or strategize the same graph differently can never alias.
    Chunk *sizes* and the cost model's per-bounds strategy choice are
    linearized against concrete bounds and live in the per-bounds table
    cache below.

Deliberately **excluded**: the loop bounds.  Two requests that differ only in
iteration count share a key (the per-bounds level tables are a second-level
cache inside :class:`repro_torch.compile.lowering.CompiledProgram`), which is what
makes the cache useful for serving traffic whose batch sizes vary.

Compute functions are fingerprinted by *code*, not identity: re-creating a
behaviorally identical lambda (same bytecode, consts, closure values) in a
new request maps to the same key, so a cache keyed this way survives the
common pattern of rebuilding the program object per request.  Changing the
bytecode, a captured constant, or a default argument changes the key.

This module is import-light on purpose (no jax, no numpy): the parallelizer
consults :func:`program_fingerprint` for its analysis memo without paying the
jax import.
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import re
import types
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.dependence import Dependence
from repro_torch.core.ir import ArrayRef, LoopProgram, is_indirect
from repro_torch.core.policy import SccPolicyLike

_PRIMITIVES = (int, float, bool, str, bytes, type(None))


def _const_fp(value: object, _seen: frozenset = frozenset()) -> object:
    """Canonicalize one captured value (nested code objects recurse — their
    ``repr`` embeds a memory address, which would break identity
    invariance; buffer-backed arrays hash their full contents — ``repr``
    truncates large arrays, which would collide distinct lookup tables).
    Cyclic containers/objects are cut with the visited set."""

    if isinstance(value, _PRIMITIVES):
        return value
    if id(value) in _seen:
        return ("cycle",)
    _seen = _seen | {id(value)}
    if isinstance(value, types.ModuleType):
        return ("module", value.__name__)
    if isinstance(value, type):
        return ("class", value.__module__, value.__qualname__)
    if isinstance(value, types.CodeType):
        return _code_fp(value, _seen)
    if isinstance(value, tuple):
        return tuple(_const_fp(v, _seen) for v in value)
    if isinstance(value, (list, set, frozenset)):
        kind = type(value).__name__
        items = [_const_fp(v, _seen) for v in value]
        if isinstance(value, (set, frozenset)):
            # sort the *canonical forms* — raw reprs would bypass the
            # address-guard/state introspection and collide distinct objects
            items = sorted(items, key=repr)
        return (kind, tuple(items))
    if isinstance(value, dict):
        return (
            "dict",
            tuple(
                sorted(
                    ((_const_fp(k, _seen), _const_fp(v, _seen))
                     for k, v in value.items()),
                    key=repr,
                )
            ),
        )
    tobytes = getattr(value, "tobytes", None)
    if callable(tobytes) and hasattr(value, "dtype"):  # ndarray-likes
        return (
            "ndarray",
            str(value.dtype),
            tuple(getattr(value, "shape", ())),
            hashlib.sha256(tobytes()).hexdigest(),
        )
    if callable(value):
        # callables captured as instance state (e.g. a policy's level_cost
        # hook) key by behavior: two distinct lambdas share the qualname
        # "<lambda>", which _object_fp would collide
        return compute_fingerprint(value, _seen=_seen)
    return _object_fp(value, _seen)


# default object reprs embed a memory address that the allocator can *reuse*
# after a free — two different objects fingerprinting equal would be a false
# cache hit, the one failure mode this module must never have
_ADDR_REPR = re.compile(r" at 0x[0-9a-fA-F]+>")
_MISS_TOKEN = itertools.count()


def _object_fp(value: object, _seen: frozenset = frozenset()) -> object:
    state = getattr(value, "__dict__", None)
    if state is None and hasattr(type(value), "__slots__"):
        state = {
            s: getattr(value, s)
            for s in type(value).__slots__
            if hasattr(value, s)
        }
    if state is not None:
        return (
            "object",
            type(value).__module__,
            type(value).__qualname__,
            tuple(
                sorted((k, _const_fp(v, _seen)) for k, v in state.items())
            ),
        )
    r = repr(value)
    if _ADDR_REPR.search(r):
        # address-bearing repr with no introspectable state: unknowable
        # behavior — force a cache miss rather than risk a false hit
        return ("opaque-unhashable", next(_MISS_TOKEN))
    return r


def _code_fp(code: types.CodeType, _seen: frozenset = frozenset()) -> Tuple:
    return (
        "code",
        code.co_code.hex(),
        tuple(_const_fp(c, _seen) for c in code.co_consts),
        code.co_names,
        code.co_varnames[: code.co_argcount + code.co_kwonlyargcount],
    )


def _all_names(code: types.CodeType) -> Tuple[str, ...]:
    """``co_names`` of ``code`` and every nested code object (lambdas in
    lambdas share the enclosing function's globals)."""

    names = list(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names.extend(_all_names(c))
    return tuple(dict.fromkeys(names))


def _value_fp(v: object, seen: frozenset) -> object:
    if callable(v):
        return compute_fingerprint(v, _seen=seen)
    return _const_fp(v, seen)


def compute_fingerprint(fn: object, *, _seen: frozenset = frozenset()) -> Tuple:
    """Behavioral fingerprint of a compute callable.

    Identity-insensitive: two functions compiled from the same source (same
    bytecode, consts, names, closure values, referenced globals, defaults)
    fingerprint equal.  Closure cells, ``functools.partial`` bindings and
    the *values of referenced globals* participate by value — a function
    whose bytecode reads ``SCALE`` from its module keys differently for
    ``SCALE=2`` and ``SCALE=3``, so the compile cache cannot silently reuse
    the wrong artifact.  Recursion through self-referencing globals/closures
    is cut with a visited set.
    """

    if id(fn) in _seen:
        return ("cycle",)
    _seen = _seen | {id(fn)}
    if isinstance(fn, type):
        # classes referenced as values key by qualified name (stable)
        return ("class", fn.__module__, fn.__qualname__)
    if isinstance(fn, types.MethodType):
        # bound methods proxy their function's __code__, but behave per
        # their receiver's state: Scaler(2).scale ≠ Scaler(3).scale
        return (
            "bound-method",
            compute_fingerprint(fn.__func__, _seen=_seen),
            _const_fp(fn.__self__, _seen),
        )
    if isinstance(fn, functools.partial):
        return (
            "partial",
            compute_fingerprint(fn.func, _seen=_seen),
            tuple(_value_fp(a, _seen) for a in fn.args),
            tuple(
                sorted(
                    (k, _value_fp(v, _seen))
                    for k, v in fn.keywords.items()
                )
            ),
        )
    code = getattr(fn, "__code__", None)
    if code is None:
        call = getattr(type(fn), "__call__", None)
        if getattr(call, "__code__", None) is not None:
            # stateful callable object: the behavior is (__call__ code ×
            # instance state) — fingerprint both, so Scaler(2) ≠ Scaler(3)
            return (
                "callable-object",
                compute_fingerprint(call, _seen=_seen),
                _object_fp(fn, _seen),
            )
        if isinstance(fn, types.BuiltinFunctionType):
            return ("builtin", fn.__module__, fn.__qualname__)
        # C-extension callables (e.g. numpy ufuncs): key on type + state /
        # stable repr — _object_fp itself forces a miss only when the repr
        # carries a reusable memory address
        return ("c-callable", _object_fp(fn, _seen))
    cells: Tuple = ()
    closure = getattr(fn, "__closure__", None)
    if closure:
        vals = []
        for cell in closure:
            try:
                v = cell.cell_contents
            except ValueError:  # pragma: no cover - empty cell
                vals.append("<empty-cell>")
                continue
            vals.append(_value_fp(v, _seen))
        cells = tuple(vals)
    defaults = getattr(fn, "__defaults__", None) or ()
    kwdefaults = getattr(fn, "__kwdefaults__", None) or {}
    fn_globals = getattr(fn, "__globals__", None) or {}
    names = _all_names(code)
    global_fp = []
    for name in names:
        if name not in fn_globals:
            continue
        v = fn_globals[name]
        if isinstance(v, types.ModuleType):
            # ``config.SCALE`` reads one attribute hop into a module: hash
            # the values of every co_name that resolves on it, so mutating
            # the module constant changes the key.  (Dynamic state further
            # away — config.get()... — is out of fingerprint scope; callers
            # with such computes should clear_compile_cache() on change.)
            global_fp.append(
                (
                    name,
                    "module",
                    v.__name__,
                    tuple(
                        (attr, _value_fp(getattr(v, attr), _seen))
                        for attr in names
                        if attr != name and hasattr(v, attr)
                    ),
                )
            )
        else:
            global_fp.append((name, _value_fp(v, _seen)))
    global_fp = tuple(global_fp)
    return (
        "fn",
        _code_fp(code, _seen),
        cells,
        tuple(_const_fp(d, _seen) for d in defaults),
        tuple(
            sorted((k, _const_fp(v, _seen)) for k, v in kwdefaults.items())
        ),
        global_fp,
    )


def _ref_sig(ref: Optional[ArrayRef]) -> Optional[Tuple]:
    if ref is None:
        return None
    if is_indirect(ref):
        # a[idx[i+o]] + c keys by (target, index array, index offset, +c) —
        # never by index *contents*: those are store data, and anything
        # store-dependent (the inspector's instance graph) lives with the
        # per-bounds tables, not the structural key
        return (
            "indirect",
            ref.array,
            ref.index.array,
            ref.index.offset_tuple(),
            ref.offset,
        )
    return (ref.array, ref.offset_tuple())


def program_signature(prog: LoopProgram) -> Tuple:
    """Bounds-free canonical form of the statement graph."""

    return (
        "loop-program",
        prog.ndim,
        tuple(
            (
                s.name,
                _ref_sig(s.write),
                tuple(_ref_sig(r) for r in s.reads),
                _ref_sig(s.guard),
                compute_fingerprint(s.compute),
            )
            for s in prog.statements
        ),
    )


def dependence_signature(deps: Sequence[Dependence]) -> Tuple:
    """Order-insensitive canonical form of a dependence set."""

    return tuple(
        sorted(
            (d.kind, d.source, d.sink, d.array, d.distance, d.nonaffine)
            for d in deps
        )
    )


def _digest(payload: Tuple) -> str:
    return hashlib.sha256(repr(payload).encode()).hexdigest()


def program_fingerprint(prog: LoopProgram) -> str:
    """Hash of the statement graph alone (no dependences, no bounds) — the
    parallelizer's analysis-memo key component."""

    return _digest(program_signature(prog))


def structural_key(
    prog: LoopProgram,
    retained: Sequence[Dependence],
    model: str = "doall",
    processors: Optional[Dict[str, object]] = None,
    chunk_limit: Optional[int] = None,
    scc_policy: SccPolicyLike = None,
    deps: Optional[str] = None,
) -> str:
    """The compile-cache key: hash of (statement graph, retained dependence
    set, execution model, SCC partition incl. bounds-free skew candidates,
    chunk knob, scheduling-policy knob, non-affine ``deps`` mode).  Loop
    bounds do not participate — under ``scc_policy="auto"`` the cost model
    may pick different strategies for different bounds of one structure,
    which is exactly why the chosen strategy lives with the per-bounds level
    tables inside the artifact while the *policy* (and the bounds-free skew
    matrix each SCC would use) lives here.  ``deps`` is the
    ``"inspect"``/``"speculate"`` *knob* only — it is structural like
    ``chunk_limit``; the inspector's store-dependent instance graph never
    reaches this key (it lives with the per-bounds tables)."""

    from repro_torch.core.policy import resolve_policy
    from repro_torch.core.scc import scc_signature

    procs = (
        tuple(sorted((k, repr(v)) for k, v in processors.items()))
        if processors
        else None
    )
    # The policy participates by full canonicalized instance state, not by
    # name or repr: _const_fp recurses into __dict__ (nested policy objects,
    # ndarray-valued knobs by content hash, address-bearing reprs forced to
    # miss), so two differently-configured custom policies can never alias
    # one artifact — the same no-false-hits bar the compute fingerprints
    # are held to.
    policy_fp = ("scc-policy", _const_fp(resolve_policy(scc_policy)))
    return _digest(
        (
            program_signature(prog),
            dependence_signature(retained),
            model,
            procs,
            scc_signature(prog, retained, model, processors),
            chunk_limit,
            policy_fp,
            deps,
        )
    )
