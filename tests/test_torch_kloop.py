"""The pipelined matmul's K-loop plan on the port, held against the
reference: the same retained and eliminated dependences, waits, credit
wait and overlap at every ring depth, and the K-loop compiled on the
``"torch"`` backend bit-equal to the sequential oracle."""

import pytest

from repro.kernels.pipelined_matmul import schedule as ref_schedule

import repro_torch.core as tc
from repro_torch.compile import CompileCache, device_scope
from repro_torch.compile.executor import run_xla as run_torch
from repro_torch.compile.structure import structural_key
from repro_torch.core.elimination import synchronized_set
from repro_torch.core.wavefront import schedule_levels
from repro_torch.kernels.pipelined_matmul import schedule


def _plan_view(p):
    return (
        p.depth,
        [d.pretty() for d in p.retained],
        [d.pretty() for d in p.eliminated],
        p.waits_per_step,
        p.credit_wait_needed,
        p.wavefront.depth,
        schedule.overlapped_levels(p.wavefront),
    )


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_plan_pipeline_equals_reference(depth):
    ref = ref_schedule.plan_pipeline(depth)
    port = schedule.plan_pipeline(depth)
    assert _plan_view(port) == (
        ref.depth,
        [d.pretty() for d in ref.retained],
        [d.pretty() for d in ref.eliminated],
        ref.waits_per_step,
        ref.credit_wait_needed,
        ref.wavefront.depth,
        ref_schedule.overlapped_levels(ref.wavefront),
    )
    assert port.summary() == ref.summary()


@pytest.mark.parametrize("depth,steps", [(1, 7), (2, 5), (3, 33)])
def test_plan_pipeline_equals_reference_at_other_extents(depth, steps):
    assert (
        schedule.plan_pipeline(depth, steps).summary()
        == ref_schedule.plan_pipeline(depth, steps).summary()
    )


def test_min_buffers_is_two():
    assert schedule.min_buffers() == 2 == ref_schedule.min_buffers()


def test_single_buffering_needs_credit_wait():
    p = schedule.plan_pipeline(depth=1)
    assert p.credit_wait_needed
    assert "anti" in {d.kind for d in p.retained}
    assert schedule.overlapped_levels(p.wavefront) == 0


def test_double_buffering_covers_anti_dep():
    p = schedule.plan_pipeline(depth=2)
    assert not p.credit_wait_needed
    assert ("anti", "COMPUTE", "LOAD") in {
        (d.kind, d.source, d.sink) for d in p.eliminated
    }
    assert ("flow", "LOAD", "COMPUTE") in {
        (d.kind, d.source, d.sink) for d in p.retained
    }
    assert schedule.overlapped_levels(p.wavefront) > 0


def test_kloop_replans_are_structural_hits():
    c16, _ = schedule.compile_kloop(2, 16, device="cpu")
    c128, hit = schedule.compile_kloop(2, 128, device="cpu")
    assert hit and c16 is c128
    _c, hit_depth1 = schedule.compile_kloop(1, 16, device="cpu")
    assert not hit_depth1  # depth changes the retained deps


def test_compile_kloop_defaults_to_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        schedule.compile_kloop(2, 16)


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("steps", [4, 16])
def test_kloop_runs_bit_equal_on_torch(depth, steps):
    p = schedule._kloop_plan(depth, steps)
    init = p.program.initial_store()
    out = p.compile("torch", device="cpu").run(store=init)
    assert out == tc.run_sequential(p.program, init)


def _procmap_kloop():
    prog = schedule.make_kloop_program(8)
    deps = schedule.kloop_dependences(2)
    retained = synchronized_set(deps, "procmap", schedule.PROCESSORS)
    sched = schedule_levels(
        prog, retained, model="procmap", processors=schedule.PROCESSORS
    )
    return tc.insert_synchronization(prog, deps), sched


def test_procmap_model_kloop():
    sync, sched = _procmap_kloop()
    with device_scope("cpu"):
        r = run_torch(
            sync, schedule=sched, model="procmap",
            processors=schedule.PROCESSORS, cache=CompileCache(),
        )
    assert r.matches_sequential


def test_schedule_carries_its_model():
    sync, sched = _procmap_kloop()
    with device_scope("cpu"):
        r = run_torch(sync, schedule=sched, cache=CompileCache())
    assert r.schedule.depth == sched.depth
    assert r.matches_sequential


def test_processor_map_changes_key():
    prog = schedule.make_kloop_program(8)
    deps = schedule.kloop_dependences(2)
    k1 = structural_key(
        prog, deps, "procmap",
        {"ISSUE": "mxu", "COMPUTE": "mxu", "LOAD": "dma"},
    )
    k2 = structural_key(
        prog, deps, "procmap",
        {"ISSUE": "dma", "COMPUTE": "mxu", "LOAD": "dma"},
    )
    assert k1 != k2
