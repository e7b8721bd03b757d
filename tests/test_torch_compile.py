"""repro_torch.compile: the ``"torch"`` backend held against the reference.

Every program of the shared corpus, under every elimination method and
every non-affine dependence mode, goes through the port's
``plan → compile("torch", device="cpu") → run`` (and its naive variant
through the backend's differential hook) and must reproduce, bit for bit,
the reference's ``run_sequential`` and its NumPy ``wavefront`` store from
the same initial memory image.  The port's host-side level tables must
equal the reference ``CompiledProgram.prepare()`` artifacts, which build
without executing any jax.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref_core
from programs import ALL_PROGRAMS
from repro.compile.cache import CompileCache as RefCompileCache
from repro.core.wavefront import _DenseStore as RefDenseStore

import repro_torch.core as tc
from repro_torch.compile import CompileCache, device_scope
from repro_torch.compile.executor import run_xla as run_torch
from repro_torch.compile.lowering import TorchLoweringError
from repro_torch.convert import program_from_reference, store_from_reference
from repro_torch.core.wavefront import _DenseStore

METHODS = ("none", "isd", "pattern", "both")
DEPS_MODES = (None, "inspect", "speculate")


def _ids(corpus):
    return [name for name, _ in corpus]


def _reference_stores(prog, method, deps, init):
    p = ref_core.plan(prog, method=method, deps=deps)
    return (
        ref_core.run_sequential(prog, init),
        p.compile("wavefront").run(store=init),
    )


@pytest.mark.parametrize("deps", DEPS_MODES, ids=lambda d: f"deps={d}")
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "name,ref_prog", ALL_PROGRAMS, ids=_ids(ALL_PROGRAMS)
)
def test_corpus_bit_equal_to_reference(name, ref_prog, method, deps):
    init = store_from_reference(ref_prog.initial_store())
    expect, ref_wavefront = _reference_stores(ref_prog, method, deps, init)
    assert ref_wavefront == expect

    prog = program_from_reference(ref_prog)
    p = tc.plan(prog, method=method, deps=deps)
    optimized = p.compile("torch", device="cpu").run(store=init)
    naive = tc.get_backend("torch").differential(
        p.naive_sync, store=init, device="cpu"
    )
    assert optimized == expect, f"{name}/{method}/optimized diverged"
    assert naive == expect, f"{name}/{method}/naive diverged"
    assert optimized == ref_wavefront


# ---------------------------------------------------------------------- #
# Host tables: equal to the reference's prepared case
# ---------------------------------------------------------------------- #

def _wide_recurrence(ni, nj):
    return ref_core.LoopProgram(
        statements=(
            ref_core.Statement(
                "S1",
                ref_core.ArrayRef("a", (0, 0)),
                (ref_core.ArrayRef("a", (0, -1)), ref_core.ArrayRef("a", (-1, 1))),
            ),
        ),
        bounds=((0, ni), (0, nj)),
    )


TABLE_CASES = [
    ("paper_alg6_16", ref_core.paper_alg6(16), None, {}),
    ("wide_skew_24x48", _wide_recurrence(24, 48), None, {"scc_policy": "skew"}),
    ("wide_chunk_12x16", _wide_recurrence(12, 16), None, {"scc_policy": "chunk"}),
    *[(n, p, None, {}) for n, p in ALL_PROGRAMS],
    *[
        (f"{n}_inspect", p, "inspect", {})
        for n, p in ALL_PROGRAMS
        if p.has_indirect()
    ],
]


def _prepared_pair(ref_prog, deps, knobs):
    init = store_from_reference(ref_prog.initial_store())
    ref_plan = ref_core.plan(ref_prog, method="isd", deps=deps)
    ref_art, _ = RefCompileCache().get_or_compile(
        ref_prog, tuple(ref_plan.retained), deps=deps, **knobs
    )
    ref_case, _ = ref_art.prepare(ref_prog, RefDenseStore(init))

    prog = program_from_reference(ref_prog)
    p = tc.plan(prog, method="isd", deps=deps)
    art, _ = CompileCache().get_or_compile(
        prog, tuple(p.retained), deps=deps, **knobs
    )
    with device_scope("cpu"):
        case, _ = art.prepare(prog, _DenseStore(init))
    return ref_case, case


def _assert_tables_equal(ref_tables, tables):
    assert len(ref_tables) == len(tables)
    for rt, t in zip(ref_tables, tables):
        assert sorted(rt) == sorted(t)
        for role in rt:
            if isinstance(rt[role], tuple):
                assert len(rt[role]) == len(t[role])
                for ra, a in zip(rt[role], t[role]):
                    assert ra.dtype == a.dtype and np.array_equal(ra, a), role
            else:
                assert rt[role].dtype == t[role].dtype, role
                assert np.array_equal(rt[role], t[role]), role


@pytest.mark.parametrize(
    "name,ref_prog,deps,knobs", TABLE_CASES, ids=[c[0] for c in TABLE_CASES]
)
def test_host_tables_equal_reference(name, ref_prog, deps, knobs):
    ref_case, case = _prepared_pair(ref_prog, deps, knobs)
    assert case.n_levels == ref_case.n_levels
    _assert_tables_equal(ref_case.tables, case.tables)
    assert len(case.seg_dyn) == len(ref_case.seg_dyn)
    for rd, d in zip(ref_case.seg_dyn, case.seg_dyn):
        assert rd.dtype == d.dtype and np.array_equal(rd, d)
    assert dataclasses.astuple(case.bucket[0]) == dataclasses.astuple(
        ref_case.bucket[0]
    )
    assert case.bucket[1:] == ref_case.bucket[1:]
    assert (case.arrays, case.flat_sizes, case.padded_sizes, case.sparse) == (
        ref_case.arrays,
        ref_case.flat_sizes,
        ref_case.padded_sizes,
        ref_case.sparse,
    )


def test_paper_alg6_16_has_31_levels_and_no_segments():
    ref_case, case = _prepared_pair(ref_core.paper_alg6(16), None, {})
    assert case.n_levels == ref_case.n_levels == 31
    assert case.static.segments is None


def test_width_ladder_band_runs_capped_steps():
    ref_case, case = _prepared_pair(
        _wide_recurrence(24, 48), None, {"scc_policy": "skew"}
    )
    assert case.static.segments is not None
    (rec,) = [d for s, d in zip(case.static.segments, case.seg_dyn) if s[0] == "rec"]
    assert rec.shape[0] > 2  # [run, row0, cut points...]: the ladder is on
    # the launch list runs the band's ramps at capped widths
    from repro_torch.compile.lowering import CompiledProgram

    launch = CompiledProgram._level_steps(case)
    assert any(cap is not None for _k, _c, cap in launch)
    assert len(launch) == sum(len(g) for g in case.schedule.levels)


# ---------------------------------------------------------------------- #
# Cache semantics, report integration, error parity
# ---------------------------------------------------------------------- #

def _chain_program(n):
    return tc.LoopProgram(
        statements=(
            tc.Statement("S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", -1),)),
            tc.Statement("S2", tc.ArrayRef("b", 0), (tc.ArrayRef("a", -2),)),
        ),
        bounds=((1, n),),
    )


def _sync(prog):
    return tc.insert_synchronization(prog, tc.analyze(prog))


def test_torch_is_registered_and_reported():
    assert "torch" in tc.registered_backends()
    rep = tc.plan(tc.paper_alg6(8), method="isd").compile(
        "torch", device="cpu"
    ).report()
    assert rep.backend == "torch" and rep.compiled is not None
    s = rep.summary()
    assert s["compile_key"] == rep.compiled.key[:16]


def test_bounds_change_is_structural_hit():
    cache = CompileCache()
    with device_scope("cpu"):
        r1 = run_torch(_sync(_chain_program(8)), cache=cache)
        r2 = run_torch(_sync(_chain_program(64)), cache=cache)
    assert r1.cache_events == {"structural": "miss", "tables": "miss"}
    assert r2.cache_events == {"structural": "hit", "tables": "miss"}
    assert r1.compiled is r2.compiled
    assert r1.matches_sequential and r2.matches_sequential


def test_warm_call_hits_both_levels():
    cache = CompileCache()
    sync = _sync(_chain_program(9))
    with device_scope("cpu"):
        run_torch(sync, cache=cache)
        r = run_torch(sync, cache=cache)
    assert r.cache_events == {"structural": "hit", "tables": "hit"}
    assert cache.stats.as_dict() == {
        "hits": 1, "misses": 1, "table_hits": 1, "table_misses": 1,
    }


def test_device_is_in_the_case_key_not_the_structural_key():
    p = tc.plan(_chain_program(8), method="isd")
    exe = p.compile("torch", device="cpu")
    exe.run()
    (key,) = exe.compiled._cases
    assert key[-1] == "cpu"
    assert exe.compiled.key == p.compile("torch", device="cpu").compiled.key


def test_compile_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = tc.plan(tc.paper_alg6(8), method="isd")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.compile("torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p.compile("torch", device="cuda")


def test_unknown_device_type_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        tc.plan(tc.paper_alg6(8)).compile("torch", device="meta")


def test_under_synchronized_mis_executes_deterministically():
    sync = tc.insert_synchronization(
        tc.paper_alg4(8), tc.dependence.paper_alg4_dependences()
    )
    with device_scope("cpu"):
        assert not run_torch(sync).matches_sequential


def test_truthiness_branching_compute_raises():
    prog = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1",
                tc.ArrayRef("b", 0),
                (tc.ArrayRef("a", -1),),
                compute=lambda a: 1.0 if a else 2.0,
            ),
        ),
        bounds=((1, 6),),
    )
    with device_scope("cpu"), pytest.raises(
        TorchLoweringError, match="cannot be evaluated"
    ):
        run_torch(_sync(prog), compare=False)


@pytest.mark.parametrize(
    "compute",
    [
        lambda x: (x == x * 1.0) * 2.0 + 1.0,
        lambda x: (x > 0.5) * 0.1 + x / 3,
        lambda x: 7.0 / (x + 10.0) - (x // 2) + (x % 3),
        lambda x: -(x < 0) + abs(x) * 3,
    ],
    ids=["eq", "gt_select", "div_family", "neg_bool_abs"],
)
def test_compute_operators_round_like_python(compute):
    prog = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1", tc.ArrayRef("a", 0), (tc.ArrayRef("a", -1),),
                compute=compute,
            ),
        ),
        bounds=((1, 12),),
    )
    init = prog.initial_store()
    out = tc.plan(prog).compile("torch", device="cpu").run(store=init)
    assert out == tc.run_sequential(prog, init)


def test_out_of_store_read_raises():
    prog = tc.LoopProgram(
        statements=(tc.Statement("S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", -20),)),),
        bounds=((0, 4),),
    )
    with device_scope("cpu"), pytest.raises(KeyError, match="initialized store"):
        run_torch(_sync(prog))


def test_out_of_store_write_raises():
    prog = tc.LoopProgram(
        statements=(tc.Statement("S1", tc.ArrayRef("a", 20), ()),),
        bounds=((0, 2),),
    )
    with device_scope("cpu"), pytest.raises(KeyError, match="initialized store"):
        run_torch(_sync(prog), store={"a": {(i,): 0.0 for i in range(4)}})


def test_guarded_out_of_store_write_raises_from_the_device_flag():
    """A guard-dependent write outside the store is flagged on the device
    and raised after the sweep (the reference's in-loop OOB flag)."""

    prog = tc.LoopProgram(
        statements=(
            tc.Statement(
                "S1", tc.ArrayRef("a", 6), (), guard=tc.ArrayRef("p", 0)
            ),
        ),
        bounds=((0, 4),),
    )
    store = {
        "a": {(i,): 0.0 for i in range(8)},
        "p": {(i,): 1.0 for i in range(4)},
    }
    with device_scope("cpu"), pytest.raises(KeyError, match="initialized store"):
        run_torch(_sync(prog), store=store)
    store["p"] = {(i,): (1.0 if i < 2 else -1.0) for i in range(4)}
    with device_scope("cpu"):
        r = run_torch(_sync(prog), store=store)
    assert r.matches_sequential


def test_sparse_store_hole_read_raises():
    prog = tc.LoopProgram(
        statements=(tc.Statement("S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", -1),)),),
        bounds=((1, 4),),
    )
    sparse = {
        "a": {(i,): 0.0 for i in range(0, 5)},
        "b": {(0,): 1.0, (4,): 2.0},
    }
    with device_scope("cpu"), pytest.raises(KeyError, match="uninitialized"):
        run_torch(_sync(prog), store=sparse)


def test_sparse_store_covered_accesses_work():
    prog = tc.LoopProgram(
        statements=(tc.Statement("S1", tc.ArrayRef("a", 0), (tc.ArrayRef("b", -1),)),),
        bounds=((1, 4),),
    )
    store = {
        "a": {(i,): 0.0 for i in range(0, 5)},
        "b": {(i,): float(i) for i in (0, 1, 2, 4)},
    }
    with device_scope("cpu"):
        r = run_torch(_sync(prog), store=store, compare=False)
    assert r.store == tc.run_sequential(prog, store)


def test_missing_array_raises():
    with device_scope("cpu"), pytest.raises(KeyError, match="missing arrays"):
        run_torch(
            _sync(_chain_program(4)),
            store={"a": {(i,): 0.0 for i in range(-8, 12)}},
        )


def test_empty_array_in_store_raises_keyerror():
    store = {"a": {(i,): 0.0 for i in range(-8, 12)}, "b": {}}
    with device_scope("cpu"), pytest.raises(KeyError, match="no initialized cells"):
        run_torch(_sync(_chain_program(4)), store=store)


def test_key_error_messages_match_reference():
    from repro.compile import lowering as ref_lowering

    from repro_torch.compile import lowering

    assert lowering._OOB_MSG == ref_lowering._OOB_MSG
    assert lowering._HOLE_MSG == ref_lowering._HOLE_MSG


def test_structural_cache_is_bounded():
    cache = CompileCache()
    cache.MAX_ENTRIES = 4
    with device_scope("cpu"):
        for k in range(9):
            prog = tc.LoopProgram(
                statements=(
                    tc.Statement("S1", tc.ArrayRef("a", 0), (tc.ArrayRef(f"b{k}", -1),)),
                ),
                bounds=((1, 5),),
            )
            run_torch(_sync(prog), cache=cache, compare=False)
    assert len(cache) <= 4
