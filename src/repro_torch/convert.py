"""Carry programs and stores across from the JAX package.

:func:`program_from_reference` rebuilds a reference ``LoopProgram`` from
this package's IR classes, field by field, with the compute callables
passed through unchanged; :func:`store_from_reference` copies a store.
Both read attributes only (duck typing) and import nothing of the
reference package, so the port stays importable without it.  Matmul
operands need no converter: they are NumPy arrays on both sides
(``torch.from_numpy``).
"""

from __future__ import annotations

from typing import Mapping

from repro_torch.core.ir import ArrayRef, IndirectRef, LoopProgram, Statement


def _ref(ref):
    """An ``ArrayRef`` / ``IndirectRef`` (or ``None``) of the port."""

    if ref is None:
        return None
    index = getattr(ref, "index", None)
    if index is not None:
        return IndirectRef(ref.array, _ref(index), int(ref.offset))
    return ArrayRef(ref.array, ref.offset)


def _statement(stmt) -> Statement:
    return Statement(
        stmt.name,
        _ref(stmt.write),
        tuple(_ref(r) for r in stmt.reads),
        compute=stmt.compute,
        guard=_ref(stmt.guard),
    )


def program_from_reference(prog) -> LoopProgram:
    """The port's ``LoopProgram`` for a reference one."""

    return LoopProgram(
        statements=tuple(_statement(s) for s in prog.statements),
        bounds=tuple(tuple(b) for b in prog.bounds),
    )


def store_from_reference(store: Mapping[str, Mapping]) -> dict:
    """A copy of a ``{array: {cell: value}}`` store."""

    return {a: dict(cells) for a, cells in store.items()}
