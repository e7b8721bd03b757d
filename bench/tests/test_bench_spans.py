"""The two readers of the program's spans (``decode.attention_ms``,
``prefill.norm_rope_ms``) on synthetic span events and ``bench.iter``
intervals, and on a CPU run, where the spans carry no device time."""

import types

import pytest
import torch
from conftest import tiny_cell

import harness
import program_spans
from repro_torch.obs import trace

S = 1_790_000_000  # a Unix-epoch second: the profiler's clock
CALLS = [(S + 0.0, S + 0.5), (S + 1.0, S + 1.5), (S + 2.0, S + 2.5)]


def _ev(name, t, ms=None, dur_us=0.0, **args):
    a = dict(args, epoch_ns=round(t * 1e9))
    if ms is not None:
        a["dur_device"] = ms
    return {"name": name, "ph": "X", "dur": dur_us, "args": a}


def _run(calls=CALLS, kernels=()):
    return types.SimpleNamespace(trace=types.SimpleNamespace(spans=list(calls),
                                                             kernels=sorted(kernels)))


@pytest.fixture
def events(monkeypatch):
    box = []
    monkeypatch.setattr(trace, "events", lambda: list(box))
    return box


def test_decode_attention_sums_a_step_and_means_over_the_steps(events):
    events += [_ev("lm.attention", S + 0.1, 2.0, layer=0), _ev("lm.attention", S + 0.2, 3.0, layer=1),
               _ev("lm.attention", S + 1.1, 4.0, layer=0), _ev("lm.attention", S + 1.4, 6.0, layer=1),
               _ev("lm.norm", S + 0.3, 100.0, layer=0), _ev("serve.decode", S + 0.05, 50.0)]
    # the third call holds no attention span: the mean is over the two that do
    assert harness.reader("decode.attention_ms")(_run()) == pytest.approx((5.0 + 10.0) / 2)


def test_prefill_norm_rope_takes_both_names(events):
    events += [_ev("lm.norm", S + 0.1, 1.0, layer=0), _ev("lm.norm", S + 0.2, 1.5, layer=0),
               _ev("lm.rope", S + 0.3, 0.5, layer=0), _ev("lm.attention", S + 0.4, 9.0, layer=0),
               _ev("lm.norm", S + 2.1, 2.0, layer=0), _ev("lm.rope", S + 2.2, 1.0, layer=0),
               _ev("lm.mlp", S + 2.3, 9.0, layer=0)]
    assert harness.reader("prefill.norm_rope_ms")(_run()) == pytest.approx((3.0 + 3.0) / 2)


def test_spans_outside_every_traced_call_are_ignored(events):
    events += [_ev("lm.attention", S - 1.0, 7.0), _ev("lm.attention", S + 0.7, 7.0),
               _ev("lm.attention", S + 3.0, 7.0), _ev("lm.attention", S + 1.2, 1.0)]
    assert harness.reader("decode.attention_ms")(_run()) == pytest.approx(1.0)
    assert harness.reader("prefill.norm_rope_ms")(_run()) is None


def test_the_boundaries_of_a_call_hold_their_spans(events):
    a, b = CALLS[1]
    events += [_ev("lm.rope", a, 1.0), _ev("lm.rope", b, 2.0)]
    assert harness.reader("prefill.norm_rope_ms")(_run()) == pytest.approx(3.0)


def test_the_cards_waits_for_the_host_inside_a_span_are_not_its_work(events):
    """A span open on the host for 1 ms whose device events lie 0.9 ms
    apart, while the card ran kernels for 0.7 ms of that host millisecond:
    0.3 ms of it the card waited for the host, so the span did 0.6 ms of
    work.  The kernels outside the span's host interval change nothing."""

    a = S + 0.1
    events += [_ev("lm.rope", a, 0.9, dur_us=1000.0, layer=0)]
    kernels = [(a - 0.0002, a + 0.0001, "before"), (a + 0.0002, a + 0.0004, "k0"),
               (a + 0.0003, a + 0.0005, "k1"),  # overlaps k0: the union counts once
               (a + 0.0006, a + 0.0009, "k2"), (a + 0.002, a + 0.003, "after")]
    got = harness.reader("prefill.norm_rope_ms")(_run(kernels=kernels))
    # the trace's seconds since the epoch are floats, good to about 0.25 us
    assert got == pytest.approx(0.9 - 0.3, abs=1e-3)
    busy = program_spans.Busy(kernels)
    assert busy.within(a, a + 0.001) == pytest.approx(0.0007, abs=1e-6)
    assert busy.within(a + 0.00025, a + 0.00035) == pytest.approx(0.0001, abs=1e-6)
    assert busy.within(a + 0.004, a + 0.005) == 0.0
    assert busy.within(a + 0.001, a) == 0.0
    assert program_spans.Busy([]).within(a, a + 1.0) == 0.0


@pytest.mark.parametrize("metric,name", [("decode.attention_ms", "lm.attention"),
                                         ("prefill.norm_rope_ms", "lm.norm")])
def test_none_without_device_time_or_spans(events, metric, name):
    read = harness.reader(metric)
    assert read(_run()) is None  # no spans at all
    events += [_ev(name, S + 0.1), _ev(name, S + 1.1)]  # spans without dur_device
    assert read(_run()) is None
    events += [{"name": name, "ph": "X", "args": {"dur_device": 1.0}}]  # no epoch stamp
    assert read(_run()) is None
    assert read(types.SimpleNamespace(trace=None)) is None  # an untraced run
    assert read(_run([])) is None


@pytest.mark.parametrize("kind", ["prefill_closed", "decode_pool"])
def test_a_traced_cpu_run_reads_none(kind):
    """On the CPU the program's spans run under the profiler but carry no
    device time: neither metric is in the line."""

    cell = tiny_cell(kind)
    trace.clear()
    out = harness.run(cell, 2**31 + 7, 0.3, True, torch.device("cpu"), 0.0)
    assert any(e["name"] in ("lm.attention", "lm.norm") for e in trace.events())
    assert not any("dur_device" in e["args"] for e in trace.events())
    for metric in ("decode.attention_ms", "prefill.norm_rope_ms"):
        assert metric not in out["metrics"]
    assert out["correct"]
