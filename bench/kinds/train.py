"""Training: the window drives the port's ``make_train_step`` step after
step on the mix's token stream.

Set-up builds the one step object with its parameters (from the seed) and
AdamW state, and drives it through the mix's ``warm_steps`` first steps on
the window's own call and feed.  The check's readings of the program come
from those steps: every leaf's first gradient as AdamW got it (its first
moment after one step over 1 - b1) and every leaf's change after the third
step (each step's loss is kept for ``control.py``).  The cell's family's
plain reference (``train``) follows the same three steps after the window.

In the traced slice the driver opens a named range around each call of the
port's attention and of ``AdamW.update``, so that the trace gives their
device time in the traced step, the attention's backward included: the
program's ``lm.attention`` span holds its forward and remat's recompute,
and autograd runs the backward outside the layer spans.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict

import torch

import harness
import traffic
import weights

CHECKED_STEPS = 3
ATTENTION, OPTIMIZER = "bench.attention", "bench.optimizer"
# a leaf whose reference gradient is below this share of the median leaf's
# moves under AdamW by round-off alone: its change is not compared
STILL_LEAF = 1e-3


def worst_leaf_gap(prog: Dict, refr: Dict, keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median leaf ref)."""

    keys = [k for k in refr if keep is None or k in keep]
    med = statistics.median(refr[k] for k in keys)
    return max(abs(prog[k] - refr[k]) / max(refr[k], med) for k in keys)


class Driver(harness.Driver):
    def setup(self) -> None:
        from repro_torch.launch.steps import make_train_step
        from repro_torch.optim.optimizer import AdamW

        self.opt = AdamW(**self.mix["optimizer"])
        self.params = weights.tree_of(self.flat_weights())
        self.state = self.opt.init(self.params)
        self.step_fn = make_train_step(self.cfg, self.opt)
        self.losses = []
        for step in range(1, self.mix["warm_steps"] + 1):
            self.losses.append(self._step(step))
            t0 = time.perf_counter()
            if step == 1:
                b1 = self.opt.b1
                self.first_grad = {p: float(torch.linalg.vector_norm(m)) / (1 - b1)
                                   for p, m in weights.paths_of(self.state.mu)}
            if step == CHECKED_STEPS:
                w0 = self.flat_weights()
                self.change = {p: float(torch.linalg.vector_norm(t.float() - w0[p].float()))
                               for p, t in weights.paths_of(self.params)}
                del w0
            self.reading_s += time.perf_counter() - t0
        self.next_step = self.mix["warm_steps"] + 1

    def _step(self, step: int) -> float:
        batch = traffic.train_batch(self.mix, self.seed, step, self.dims.vocab_size, self.device)
        self.params, self.state, m = self.step_fn(self.params, self.state, batch)
        return float(m["loss"])

    def call(self, i: int) -> dict:
        t0 = time.perf_counter()
        loss = self._step(self.next_step)
        t1 = time.perf_counter()
        self.next_step += 1
        return {"t0": t0, "t1": t1, "loss": loss, "requests": 1,
                "tokens": self.mix["batch"] * self.mix["seq_len"]}

    @contextlib.contextmanager
    def traced_ranges(self):
        from torch.profiler import record_function

        from repro_torch.models import attention

        def ranged(name, fn):
            def call(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)

            return call

        plain = attention.chunked_attention
        attention.chunked_attention = ranged(ATTENTION, plain)
        object.__setattr__(self.opt, "update", ranged(OPTIMIZER, self.opt.update))
        try:
            yield
        finally:
            attention.chunked_attention = plain
            object.__delattr__(self.opt, "update")

    def release(self) -> None:
        del self.params, self.state, self.step_fn
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, mm=None, rows=None) -> dict:
        """The reference's three steps, every product through ``mm`` (the
        family's ``exact`` by default): losses, first gradients (after the
        clip, and before it) and each leaf's change."""

        w0 = self.flat_weights()
        batches = [traffic.train_batch(self.mix, self.seed, s, self.dims.vocab_size, self.device)
                   for s in range(1, CHECKED_STEPS + 1)]
        out = self.family.train(w0, batches, self.dims, self.mix["optimizer"],
                                mm or self.family.exact, rows=rows)
        out["change"] = {p: float(torch.linalg.vector_norm(out["params"][p].float() - w0[p].float()))
                         for p in w0}
        del out["params"], w0
        return out

    def numbers(self, prog: dict, refr: dict) -> Dict[str, float]:
        raw = refr["first_grad_raw"]
        med = statistics.median(raw.values())
        moving = {p for p, g in raw.items() if g >= STILL_LEAF * med}
        # each step's loss is not compared: sound runs read 5e-6 to 8e-5 of it
        # and the control 1.5e-4 to 4.4e-4, under three times as much (PERF.md)
        return {
            "grad_gap": worst_leaf_gap(prog["first_grad"], refr["first_grad"]),
            "change_gap": worst_leaf_gap(prog["change"], refr["change"], moving),
        }

    def program_readings(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad, "change": self.change}

    def check(self, iters) -> Dict[str, float]:
        return self.numbers(self.program_readings(), self.reference())
