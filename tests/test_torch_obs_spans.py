"""The spans of the port's LM path (``repro_torch.obs.trace`` and
``repro_torch.spans``), on the CPU: the off path, the spans of a prefill, a
decode step and a train step, the profiler's switch, the clock shared with
the profiler, the merged Chrome export, device time through a timer, and
the attribute swap a caller may make around the attention and the update."""

import collections
import dataclasses
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import profile, record_function

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models import attention, model_zoo
from repro_torch.obs import trace
from repro_torch.optim.optimizer import AdamW

LAYER_SPANS = ("lm.norm", "lm.qkv", "lm.rope", "lm.cache_write", "lm.attention",
               "lm.out_proj", "lm.mlp")
TIMED = set(LAYER_SPANS) | {"lm.unembed", "serve.prefill", "serve.decode", "train.step",
                            "optim.update"}
# spans a layer opens in each mode: two norms, the rest once; train writes no cache
PER_LAYER = {"prefill": dict.fromkeys(LAYER_SPANS, 1) | {"lm.norm": 2},
             "decode": dict.fromkeys(LAYER_SPANS, 1) | {"lm.norm": 2},
             "train": dict.fromkeys(LAYER_SPANS, 1) | {"lm.norm": 2, "lm.cache_write": 0}}


@pytest.fixture(autouse=True)
def _fresh_buffer():
    trace.disable()
    trace.clear()
    yield
    trace.disable()
    trace.clear()


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("granite_3_2b")
    return cfg, model_zoo.init(cfg, device="cpu", seed=3)


def _tokens(cfg, b=2, s=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=g)


def _prefill(cfg, params, tokens):
    cache = model_zoo.init_cache(cfg, tokens.shape[0], 16, device="cpu")
    return make_prefill_step(cfg)(params, {"tokens": tokens}, cache)


def _decode(cfg, params, tokens):
    _, cache = _prefill(cfg, params, tokens)
    return make_serve_step(cfg)(params, tokens[:, -1:], cache, tokens.shape[1])


def _train(cfg, params, tokens, remat="full", opt=None):
    cfg = dataclasses.replace(cfg, remat=remat)
    opt = opt or AdamW()
    return make_train_step(cfg, opt)(params, opt.init(params),
                                     {"tokens": tokens, "labels": tokens})


class FakeTimer:
    """A device timer whose marks are counters: a span's device time is the
    number of marks recorded inside it."""

    def __init__(self):
        self.n = 0

    def record(self):
        self.n += 1
        return self.n

    def elapsed_ms(self, a, b):
        return float(b - a)


# ---------------------------------------------------------------------- #
# off
# ---------------------------------------------------------------------- #

def test_off_path_returns_the_shared_null_context_and_records_nothing(model):
    cfg, params = model
    assert trace.module("lm.norm", 3, True) is trace.NULL
    assert trace.module("lm.embed") is trace.NULL
    assert trace.call("serve.decode", FakeTimer(), tokens=4) is trace.NULL
    assert trace.span("plan") is trace.NULL
    assert spans.step("serve.prefill", _tokens(cfg)) is trace.NULL
    _decode(cfg, params, _tokens(cfg))
    _train(cfg, params, _tokens(cfg))
    assert trace.events() == [] and not trace.tracing_enabled()


# ---------------------------------------------------------------------- #
# the spans of each step
# ---------------------------------------------------------------------- #

def _one_call(events, step):
    calls = {e["args"].get("call") for e in events}
    assert len(calls) == 1 and None not in calls, calls
    (root,) = [e for e in events if e["name"] == step]
    assert root["args"]["depth"] == 1 and root["args"]["parent"] is None
    return root


def _check_layers(events, cfg, mode, passes=1):
    counts = collections.Counter((e["name"], e["args"]["layer"]) for e in events
                                 if "layer" in e["args"])
    want = {(name, layer): n * passes for name, n in PER_LAYER[mode].items() if n
            for layer in range(cfg.num_layers)}
    assert dict(counts) == want


def _check_nesting(events, step):
    root = next(e for e in events if e["name"] == step)
    end = root["ts"] + root["dur"]
    for e in events:
        if e is root:
            continue
        assert e["args"]["parent"] == step and e["args"]["depth"] == 2, e
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end


def test_prefill_spans(model):
    cfg, params = model
    tokens = _tokens(cfg)
    with trace.tracing():
        _prefill(cfg, params, tokens)
    ev = trace.events()
    root = _one_call(ev, "serve.prefill")
    assert root["args"]["tokens"] == tokens.numel()
    _check_layers(ev, cfg, "prefill")
    _check_nesting(ev, "serve.prefill")
    names = collections.Counter(e["name"] for e in ev)
    assert names["lm.embed"] == names["lm.unembed"] == 1 and "lm.sample" not in names


def test_decode_step_spans(model):
    cfg, params = model
    tokens = _tokens(cfg)
    _, cache = _prefill(cfg, params, tokens)
    with trace.tracing():
        make_serve_step(cfg)(params, tokens[:, -1:], cache, tokens.shape[1])
    ev = trace.events()
    root = _one_call(ev, "serve.decode")
    assert root["args"]["tokens"] == tokens.shape[0]
    _check_layers(ev, cfg, "decode")
    _check_nesting(ev, "serve.decode")
    names = collections.Counter(e["name"] for e in ev)
    assert names["lm.embed"] == names["lm.unembed"] == names["lm.sample"] == 1
    sample = next(e for e in ev if e["name"] == "lm.sample")
    unembed = next(e for e in ev if e["name"] == "lm.unembed")
    assert sample["ts"] >= unembed["ts"] + unembed["dur"]


@pytest.mark.parametrize("remat,passes", [("full", 2), ("none", 1)])
def test_train_step_spans_include_the_recompute(model, remat, passes):
    cfg, params = model
    with trace.tracing():
        _train(cfg, params, _tokens(cfg), remat)
    ev = trace.events()
    _one_call(ev, "train.step")
    _check_layers(ev, cfg, "train", passes)
    _check_nesting(ev, "train.step")
    names = collections.Counter(e["name"] for e in ev)
    assert names["optim.update"] == names["lm.embed"] == names["lm.unembed"] == 1
    if passes == 2:  # the recompute runs in the backward, after the forward's unembed
        unembed = next(e for e in ev if e["name"] == "lm.unembed")
        late = [e for e in ev if e["name"] == "lm.attention" and e["ts"] > unembed["ts"]]
        assert len(late) == cfg.num_layers


def test_each_step_opens_its_own_call(model):
    cfg, params = model
    opt = AdamW()
    with trace.tracing():
        _decode(cfg, params, _tokens(cfg))
        opt.update(params, opt.init(params), params)  # alone: a call of its own
    ev = trace.events()
    roots = [e for e in ev if e["args"]["depth"] == 1]
    assert [e["name"] for e in roots] == ["serve.prefill", "serve.decode", "optim.update"]
    assert len({e["args"]["call"] for e in roots}) == 3
    for root in roots:
        inside = [e for e in ev if e["args"]["call"] == root["args"]["call"]]
        assert all(e is root or e["args"]["parent"] == root["name"] for e in inside)


def test_module_span_on_a_thread_without_frames_joins_the_open_call():
    """As autograd's device thread runs a checkpointed block's recompute:
    the block hands it the span its forward ran under, which the thread
    joins; a thread that is handed none opens no call."""

    seen = []

    def worker(outer):
        with trace.module("lm.rope", 0, True):  # not handed the call: none to join
            pass
        with trace.joined(outer):
            with trace.module("lm.norm", 0, True):
                pass
        assert trace.current() is None  # the join ends with its block
        seen.append(True)

    with trace.tracing():
        assert trace.current() is None and trace.joined(None) is trace.NULL
        with trace.call("train.step", FakeTimer(), tokens=8):
            outer = trace.current()
            assert trace.joined(outer) is trace.NULL  # this thread has it open already
            t = threading.Thread(target=worker, args=(outer,))
            t.start()
            t.join(timeout=30)
        assert not t.is_alive() and seen
        with trace.module("lm.norm", 0, True):  # no call open: none to join
            pass
    assert trace.current() is None
    ev = trace.events()
    (root,) = [e for e in ev if e["name"] == "train.step"]
    here = threading.get_ident()
    norm = next(e for e in ev if e["name"] == "lm.norm" and e["tid"] != here)
    assert norm["args"]["call"] == root["args"]["call"]
    assert norm["args"]["parent"] == "train.step" and norm["args"]["depth"] == 2
    assert "dur_device" in norm["args"]
    rope = next(e for e in ev if e["name"] == "lm.rope")
    assert rope["tid"] != here and rope["args"]["parent"] is None
    assert "call" not in rope["args"] and "dur_device" not in rope["args"]
    lone = next(e for e in ev if e["name"] == "lm.norm" and e["tid"] == here)
    assert "call" not in lone["args"] and lone["args"]["parent"] is None


def test_steps_traced_on_two_threads_at_once_keep_their_calls_apart(model):
    """Two threads each run prefills and decode steps, each call inside a
    ``tracing()`` block of its own (as under a profiler): one thread's block
    ending leaves the other's on, and no span joins the other's call."""

    cfg, params = model
    rounds = 3
    barrier = threading.Barrier(2)
    errors = []

    def worker(seed):
        try:
            tokens = _tokens(cfg, seed=seed)
            barrier.wait(timeout=30)
            for _ in range(rounds):
                with trace.tracing():
                    _, cache = _prefill(cfg, params, tokens)
                with trace.tracing():
                    make_serve_step(cfg)(params, tokens[:, -1:], cache, tokens.shape[1])
        except BaseException as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the two threads finely
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not errors and not any(t.is_alive() for t in threads)
    assert not trace.tracing_enabled()
    by_call = collections.defaultdict(list)
    for e in trace.events():
        by_call[e["args"]["call"]].append(e)
    assert len(by_call) == 2 * 2 * rounds
    for evs in by_call.values():
        assert len({e["tid"] for e in evs}) == 1
        (root,) = [e for e in evs if e["args"]["depth"] == 1]
        _check_layers(evs, cfg, root["name"].split(".")[1])
        _check_nesting(evs, root["name"])


# ---------------------------------------------------------------------- #
# device time
# ---------------------------------------------------------------------- #

def test_timed_spans_read_device_time_from_the_calls_timer():
    fake = FakeTimer()
    with trace.tracing():
        with trace.call("serve.decode", fake, tokens=2):
            with trace.module("lm.embed"):
                pass
            with trace.module("lm.norm", 0, True):
                with trace.module("lm.rope", 0, True):
                    pass
            with trace.module("lm.sample"):
                pass
            with trace.call("optim.update", None):  # joins: the call's timer
                pass
        with trace.module("lm.norm", 0, True):  # outside any call: no timer
            pass
    ev = {(e["name"], "call" in e["args"]): e["args"] for e in trace.events()}
    assert ev["lm.rope", True]["dur_device"] == 1.0  # its two marks in a row
    assert ev["lm.norm", True]["dur_device"] == 3.0  # its own two and lm.rope's
    assert ev["optim.update", True]["dur_device"] == 1.0
    assert ev["serve.decode", True]["dur_device"] == 7.0
    for key in (("lm.embed", True), ("lm.sample", True), ("lm.norm", False)):
        assert "dur_device" not in ev[key]
    assert fake.n == 8


def test_no_device_time_on_the_cpu(model):
    cfg, params = model
    assert spans.timer(torch.device("cpu")) is None
    with trace.tracing():
        _decode(cfg, params, _tokens(cfg))
        _train(cfg, params, _tokens(cfg))
    ev = trace.events()
    assert {e["name"] for e in ev} >= TIMED
    assert not any("dur_device" in e["args"] for e in ev)


# ---------------------------------------------------------------------- #
# the profiler
# ---------------------------------------------------------------------- #

def test_spans_turn_on_under_the_profiler_and_off_after_it(model):
    cfg, params = model
    tokens = _tokens(cfg)
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _prefill(cfg, params, tokens)
        assert not trace.tracing_enabled()  # on for each call, not past it
    ev = trace.events()
    _one_call(ev, "serve.prefill")
    _check_layers(ev, cfg, "prefill")
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not any(n.startswith("lm.") or n.startswith("serve.") for n in names)
    _prefill(cfg, params, tokens)
    assert len(trace.events()) == len(ev) and not trace.tracing_enabled()


def _marked(ev):
    t0 = ev["args"]["epoch_ns"]
    return t0, t0 + round(ev["dur"] * 1000)


def test_a_profiler_range_inside_a_span_lies_inside_its_epoch_interval():
    slack = 100_000  # ns
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            torch.ones(4).sum()
        with trace.tracing():
            for i in range(3):
                with trace.span(f"outer{i}"):
                    time.sleep(0.002)
                    with record_function(f"mark{i}"):
                        torch.ones(4).sum()
                    time.sleep(0.002)
    spans_ = {e["name"]: _marked(e) for e in trace.events()}
    marks = {e.name(): (e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("mark")}
    assert len(marks) == 3
    for i in range(3):
        (a, b), (ma, mb) = spans_[f"outer{i}"], marks[f"mark{i}"]
        assert a - slack <= ma and mb <= b + slack, (a, b, ma, mb)
        assert ma - a >= 1_000_000 and b - mb >= 1_000_000  # the sleeps, not the slack


def test_epoch_stamps_follow_the_wall_clock():
    before = time.time_ns()
    with trace.tracing():
        with trace.span("s"):
            pass
    after = time.time_ns()
    (ev,) = trace.events()
    assert before - 100_000 <= ev["args"]["epoch_ns"] <= after + 100_000


def test_merged_chrome_export_puts_spans_and_profile_on_one_timeline(tmp_path):
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with record_function("warm"):
            torch.ones(4).sum()
        with trace.tracing():
            with trace.call("serve.decode", None, tokens=1):
                time.sleep(0.002)
                with record_function("mark"):
                    torch.ones(4).sum()
                time.sleep(0.002)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    merged = trace.merge_chrome_trace(doc)
    json.dumps(merged)
    assert {k: v for k, v in merged.items() if k != "traceEvents"} == \
        {k: v for k, v in doc.items() if k != "traceEvents"}
    evs = merged["traceEvents"]
    assert evs[:len(doc["traceEvents"])] == doc["traceEvents"]
    (span,) = [e for e in evs if e.get("name") == "serve.decode"]
    (mark,) = [e for e in evs if e.get("name") == "mark" and e.get("ph") == "X"]
    slack = 100.0  # us
    assert span["ts"] - slack <= mark["ts"]
    assert mark["ts"] + mark["dur"] <= span["ts"] + span["dur"] + slack
    assert mark["ts"] - span["ts"] >= 1000 and span["ts"] + span["dur"] - mark["ts"] >= 1000
    names = [e for e in evs if e.get("ph") == "M" and e.get("name") == "thread_name"
             and e["args"]["name"] == "repro_torch spans"]
    assert [(e["pid"], e["tid"]) for e in names] == [(span["pid"], span["tid"])]


# ---------------------------------------------------------------------- #
# a caller's attribute swap around the attention and the update
# ---------------------------------------------------------------------- #

def test_swapped_attention_and_update_see_every_call(model, monkeypatch):
    """A caller that swaps ``attention.chunked_attention`` and an
    optimizer's ``update`` as attributes (a profiler's named ranges) still
    sees every call, with tracing on and off, the recompute's included."""

    cfg, params = model
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)

        return call

    opt = AdamW()
    monkeypatch.setattr(attention, "chunked_attention",
                        counted("attention", attention.chunked_attention))
    object.__setattr__(opt, "update", counted("update", opt.update))
    try:
        for on in (False, True):
            calls.clear()
            with trace.tracing() if on else trace.NULL:
                _train(cfg, params, _tokens(cfg), "full", opt)
            assert calls == {"attention": 2 * cfg.num_layers, "update": 1}
    finally:
        object.__delattr__(opt, "update")
    ev = trace.events()
    assert sum(e["name"] == "lm.attention" for e in ev) == 2 * cfg.num_layers
