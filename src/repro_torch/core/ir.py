"""Loop-program intermediate representation.

The paper (§2–§4) operates on single loops (and rectangular loop nests) whose
bodies are straight-line statements with affine array accesses ``a[i - d]``.
This module defines that IR:

  * :class:`ArrayRef`  — an access ``array[i + offset]`` (offset may be
    negative; ``a[i-1]`` is ``ArrayRef("a", -1)``).
  * :class:`IndirectRef` — a *non-affine* access ``array[idx[i + k] + offset]``
    through an index array (gather/scatter, sparse matvec, histogram).  The
    subscript is only known once the index array's contents are — the
    inspector (:mod:`repro_torch.core.inspector`) evaluates it at plan-per-bounds
    time; static analysis treats it conservatively.
  * :class:`Statement` — one statement ``S_k``: a single write plus a list of
    reads and an opaque compute function used by the reference executors.
  * :class:`LoopProgram` — ``for i = lo; i < hi; i++ { S1; ...; Sk }``.

The IR is deliberately *executable*: both the sequential oracle and the
multi-threaded send/wait executor (:mod:`repro_torch.core.executor`) interpret it
directly, so every transformation in :mod:`repro_torch.core` can be checked for
semantic equivalence, exactly in the paper's shared-memory setting.

Multi-dimensional iteration spaces (used when the sync optimizer is lifted to
(stage × microbatch) pipeline schedules, :mod:`repro_torch.core.schedule`) reuse the
same classes with tuple-valued offsets/distances.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

Offset = Union[int, Tuple[int, ...]]


def _as_tuple(off: Offset) -> Tuple[int, ...]:
    if isinstance(off, tuple):
        return off
    return (int(off),)


@dataclasses.dataclass(frozen=True)
class ArrayRef:
    """An affine access ``array[i + offset]`` (per-dimension for nests)."""

    array: str
    offset: Offset = 0

    def offset_tuple(self) -> Tuple[int, ...]:
        return _as_tuple(self.offset)

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        offs = self.offset_tuple()
        idx = ",".join(
            f"i{k}{o:+d}" if o else f"i{k}" for k, o in enumerate(offs)
        )
        return f"{self.array}[{idx}]"


@dataclasses.dataclass(frozen=True)
class IndirectRef:
    """A non-affine access ``array[idx[i + index.offset] + offset]``.

    ``index`` is the (affine) access that fetches the subscript from the
    index array; its value is truncated toward zero (``int()``) and ``offset``
    added to form the target cell.  Restricted to 1-D loop nests — the
    paper's non-affine scenarios (gather/scatter, sparse matvec, histogram)
    are all 1-D.  The index array must not be written anywhere in the loop
    (the classic inspector–executor requirement: subscripts are computable
    at loop entry); :class:`LoopProgram` rejects programs that violate it.
    """

    array: str
    index: ArrayRef
    offset: int = 0

    def offset_tuple(self) -> Tuple[int, ...]:
        """Rank marker only — the *index access* offset, so rank validation
        and windowing treat the ref as rank-1.  Never use it to compute the
        target cell; that is :func:`ref_cell`'s job."""

        return self.index.offset_tuple()

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        o = self.index.offset_tuple()[0]
        inner = f"i{o:+d}" if o else "i"
        outer = f"{self.offset:+d}" if self.offset else ""
        return f"{self.array}[{self.index.array}[{inner}]{outer}]"


def is_indirect(ref) -> bool:
    return isinstance(ref, IndirectRef)


def ref_arrays(ref) -> Tuple[str, ...]:
    """Arrays an access touches: the target and, if indirect, the index."""

    if is_indirect(ref):
        return (ref.array, ref.index.array)
    return (ref.array,)


def ref_cell(ref, point: Tuple[int, ...], mem: Mapping[str, dict]) -> Tuple[int, ...]:
    """The store cell an access resolves to at iteration ``point``.

    Affine refs need no memory; indirect refs fetch the subscript from the
    index array (KeyError on uninitialized index cells, like any read).
    """

    if is_indirect(ref):
        iidx = tuple(p + o for p, o in zip(point, ref.index.offset_tuple()))
        return (int(mem[ref.index.array][iidx]) + ref.offset,)
    return tuple(p + o for p, o in zip(point, ref.offset_tuple()))


ComputeFn = Callable[..., float]


def _default_compute(*reads: float) -> float:
    """Deterministic, order-sensitive combiner used when no compute is given.

    It is intentionally non-commutative-ish (alternating add/sub with index
    weights) so that executing statements in a wrong order produces wrong
    values — silent reorder bugs cannot hide behind commutativity.
    """

    acc = 1.0
    for k, r in enumerate(reads):
        acc = acc + (r * (k + 1) if k % 2 == 0 else -r / (k + 2))
    return acc


@dataclasses.dataclass(frozen=True)
class Statement:
    """``write.array[i+write.offset] = f(reads...)``.

    ``name`` is the paper-style label (``"S1"``).  ``compute`` consumes the
    read values (in ``reads`` order) and returns the value to store.

    ``guard`` (optional) models the paper's control dependence δc (§2.1):
    the statement executes only if the guard access is positive at run time
    — e.g. ``guard=ArrayRef("p", -1)`` is ``if (p[i-1] > 0) S``.  The guard
    read participates in dependence analysis like any read, and the δc edge
    from the statement that *writes* the guard is emitted explicitly.
    """

    name: str
    write: ArrayRef
    reads: Tuple[ArrayRef, ...]
    compute: ComputeFn = _default_compute
    guard: Optional[ArrayRef] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "reads", tuple(self.reads))

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        rhs = " , ".join(str(r) for r in self.reads) or "..."
        return f"{self.name}: {self.write} <- f({rhs})"


@dataclasses.dataclass(frozen=True)
class LoopProgram:
    """``for i in [lo, hi) { statements }`` (rectangular nest when ndim>1).

    ``bounds`` is a sequence of (lo, hi) per loop dimension.  The paper's
    examples are 1-D (``for i=1; i<n; i++``); the pipeline-schedule lift uses
    2-D (stage, microbatch).
    """

    statements: Tuple[Statement, ...]
    bounds: Tuple[Tuple[int, int], ...] = ((1, 8),)

    def __post_init__(self) -> None:
        object.__setattr__(self, "statements", tuple(self.statements))
        object.__setattr__(
            self, "bounds", tuple((int(lo), int(hi)) for lo, hi in self.bounds)
        )
        ndim = len(self.bounds)
        index_arrays: set = set()
        written: set = set()
        for s in self.statements:
            if is_indirect(s.guard):
                raise ValueError(
                    f"{s.name}: guards must be affine accesses, got {s.guard}"
                )
            refs = (s.write, *s.reads) + ((s.guard,) if s.guard else ())
            for ref in refs:
                if is_indirect(ref):
                    if ndim != 1:
                        raise ValueError(
                            f"{s.name}: indirect access {ref} requires a 1-D "
                            f"loop nest, got rank {ndim}"
                        )
                    index_arrays.add(ref.index.array)
                if len(ref.offset_tuple()) != ndim:
                    raise ValueError(
                        f"{s.name}: access {ref} has rank "
                        f"{len(ref.offset_tuple())} but loop nest has rank {ndim}"
                    )
            written.add(s.write.array)
        clobbered = index_arrays & written
        if clobbered:
            raise ValueError(
                f"index array(s) {sorted(clobbered)} are written inside the "
                f"loop — indirect subscripts must be computable at loop entry "
                f"(inspector–executor requirement)"
            )

    # ------------------------------------------------------------------ #
    @property
    def ndim(self) -> int:
        return len(self.bounds)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.statements)

    def statement(self, name: str) -> Statement:
        for s in self.statements:
            if s.name == name:
                return s
        raise KeyError(name)

    def lexical_index(self, name: str) -> int:
        for k, s in enumerate(self.statements):
            if s.name == name:
                return k
        raise KeyError(name)

    def arrays(self) -> Tuple[str, ...]:
        seen = []
        for s in self.statements:
            refs = (s.write, *s.reads) + ((s.guard,) if s.guard else ())
            for ref in refs:
                for arr in ref_arrays(ref):
                    if arr not in seen:
                        seen.append(arr)
        return tuple(seen)

    def has_indirect(self) -> bool:
        """True iff any access goes through an index array."""

        return any(
            is_indirect(ref)
            for s in self.statements
            for ref in (s.write, *s.reads)
        )

    def index_arrays(self) -> Tuple[str, ...]:
        """The index arrays feeding indirect subscripts (loop-invariant by
        the __post_init__ contract)."""

        seen = []
        for s in self.statements:
            for ref in (s.write, *s.reads):
                if is_indirect(ref) and ref.index.array not in seen:
                    seen.append(ref.index.array)
        return tuple(seen)

    def iterations(self) -> Sequence[Tuple[int, ...]]:
        """All iteration points in lexicographic (sequential) order."""

        return iterations_of(self.bounds)

    # ------------------------------------------------------------------ #
    def initial_store(self, pad: int = 8) -> dict:
        """A deterministic initial memory image covering all accesses.

        Arrays are dense dicts ``{index_tuple: value}`` padded ``pad`` cells
        beyond the loop bounds on each side so that out-of-iteration reads
        (``b[i-2]`` at ``i=1``) hit initialized memory, as in Fortran dusty
        decks where arrays are pre-initialized.
        """

        store: dict = {}
        for arr in self.arrays():
            cells: dict = {}
            ranges = [range(lo - pad, hi + pad) for lo, hi in self.bounds]
            idxs: list[Tuple[int, ...]] = [()]
            for r in ranges:
                idxs = [p + (i,) for p in idxs for i in r]
            for idx in idxs:
                # deterministic pseudo-random-ish initial content
                h = hash((arr, idx)) % 1000003
                cells[idx] = (h % 97) / 7.0 - 5.0
            store[arr] = cells
        return store


def iterations_of(
    bounds: Sequence[Tuple[int, int]]
) -> list[Tuple[int, ...]]:
    """Iteration points of a rectangular nest in lexicographic order.

    The single definition of sequential iteration order —
    :meth:`LoopProgram.iterations` and the scheduling-policy cost model
    both delegate here, so the contract cannot silently diverge.
    """

    pts: list[Tuple[int, ...]] = [()]
    for lo, hi in bounds:
        pts = [p + (i,) for p in pts for i in range(lo, hi)]
    return pts


def run_sequential(prog: LoopProgram, store: Mapping[str, dict] | None = None) -> dict:
    """Execute ``prog`` exactly as written, sequentially.  The oracle."""

    mem = {a: dict(c) for a, c in (store or prog.initial_store()).items()}
    for point in prog.iterations():
        for s in prog.statements:
            if s.guard is not None:
                gidx = tuple(
                    p + o for p, o in zip(point, s.guard.offset_tuple())
                )
                if not mem[s.guard.array][gidx] > 0:
                    continue
            reads = [mem[r.array][ref_cell(r, point, mem)] for r in s.reads]
            widx = ref_cell(s.write, point, mem)
            mem[s.write.array][widx] = s.compute(*reads)
    return mem


# ---------------------------------------------------------------------- #
# The paper's didactic programs (Algorithms 1, 4 and 6).
# ---------------------------------------------------------------------- #

def paper_alg1(n: int = 8) -> LoopProgram:
    """Alg. 1: the acyclic-dependence example (Fig. 3a)."""

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", 0), (ArrayRef("b", -1),)),
            Statement("S2", ArrayRef("b", 0), (ArrayRef("c", -1),)),
            Statement(
                "S3",
                ArrayRef("t", 0),
                (ArrayRef("a", -1), ArrayRef("b", 0), ArrayRef("d", -2)),
            ),
            Statement("S4", ArrayRef("d", 0), (ArrayRef("b", -2),)),
        ),
        bounds=((1, n),),
    )


def paper_alg4(n: int = 8) -> LoopProgram:
    """Alg. 4: the cross-iteration cyclic example (Fig. 5)."""

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", 0), (ArrayRef("b", -1),)),
            Statement("S2", ArrayRef("b", 0), (ArrayRef("c", -1),)),
            Statement(
                "S3", ArrayRef("c", 0), (ArrayRef("b", -2), ArrayRef("a", -1))
            ),
        ),
        bounds=((1, n),),
    )


def paper_alg6(n: int = 8) -> LoopProgram:
    """Alg. 6: the synchronization-elimination example (Fig. 6)."""

    return LoopProgram(
        statements=(
            Statement("S1", ArrayRef("a", 0), ()),
            Statement("S2", ArrayRef("b", 0), (ArrayRef("c", -1),)),
            Statement("S3", ArrayRef("c", 0), (ArrayRef("a", -2),)),
        ),
        bounds=((1, n),),
    )
