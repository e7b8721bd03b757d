"""Prefill, closed loop: one client sends a batch of prompts of one length,
waits for the first token of each, and sends the next.  The window drives
the port's ``make_prefill_step`` over one KV cache sized for the longest
prompt, then takes the greedy first token of each prompt to the host, as
``launch/serve_lm.generate`` does with ``new_tokens=1``.

The time to first token of a request is from the call's submission to its
token on the host.  The check samples calls drawn from the seed, one of the
longest length among them, and holds each of their prompts' served token
and last-position logit row (the program's output, kept on the device
through the window) to the logits of the cell's family's plain reference
over the prompt (``last_logits`` with ``exact``).  The control is read at
the same positions: the reference in float8 (``fp8``) in the program's
place.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

import harness
import traffic
import weights

WARM_STREAM = 1 << 40  # prompt streams of the warm-up calls, apart from the window's


class Driver(harness.Driver):
    def setup(self) -> None:
        from repro_torch.launch.steps import make_prefill_step
        from repro_torch.models import model_zoo

        mix, V = self.mix, self.dims.vocab_size
        self.params = weights.tree_of(self.flat_weights())
        self.cache = model_zoo.init_cache(self.cfg, mix["batch"], max(mix["lengths"]) + 1,
                                          device=self.device)
        self.prefill = make_prefill_step(self.cfg)
        self.lengths = traffic.prefill_lengths(mix, self.seed, mix["pool_calls"])
        self.prompts = [traffic.prompts(self.seed, i, mix["batch"], n, V, self.device)
                        for i, n in enumerate(self.lengths)]
        for j, n in enumerate(mix["lengths"]):  # every shape the window sends, once
            toks = traffic.prompts(self.seed, WARM_STREAM + j, mix["batch"], n, V, self.device)
            self._first_tokens(toks)

    def _first_tokens(self, tokens: torch.Tensor):
        logits, self.cache = self.prefill(self.params, {"tokens": tokens}, self.cache)
        t_ret = time.perf_counter()
        last = logits[:, -1, :]
        return torch.argmax(last, dim=-1).to(torch.int32).cpu(), last, t_ret

    def call(self, i: int) -> dict:
        k = i % len(self.prompts)
        t0 = time.perf_counter()
        served, last, t_ret = self._first_tokens(self.prompts[k])
        t1 = time.perf_counter()
        return {"t0": t0, "t_ret": t_ret, "t1": t1, "prompt": k, "length": self.lengths[k],
                "served": served, "logits": last, "requests": self.mix["batch"]}

    def release(self) -> None:
        del self.params, self.cache, self.prefill
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, iters) -> list:
        """The calls the check reads: one of the longest, drawn from the
        seed, and ``check_calls - 1`` more."""

        top = max(r["length"] for r in iters)
        longest = [j for j, r in enumerate(iters) if r["length"] == top]
        first = longest[traffic.sample(self.seed, 1, len(longest), 1)[0]]
        rest = [j for j in range(len(iters)) if j != first]
        more = [rest[j] for j in traffic.sample(self.seed, 2, len(rest), self.mix["check_calls"] - 1)]
        return [iters[j] for j in [first] + more]

    def readings(self, iters, control: bool = False) -> Dict[str, float]:
        """The check's numbers over the sampled calls' prompts, at their
        last position: the served token's gap below the reference's best
        logit, and the widest gap between the logit row and the
        reference's, both in units of the reference's logits' standard
        deviation there.  With ``control`` the float8 reference's argmax
        and row stand in for the program's.

        A family's ``last_logits`` gives one row, or several (R, V) where
        its reference cannot tell at the configuration's precision which
        computation the model makes (an MoE router's near tie); a prompt
        is then judged against the row nearest the program's."""

        w = self.flat_weights()
        V = self.dims.vocab_size
        served_gap = logit_gap = 0.0
        for r in self.sample(iters):
            toks = self.prompts[r["prompt"]]
            for b in range(toks.shape[0]):
                rows = self.family.last_logits(w, toks[b], self.dims, self.family.exact)
                if control:
                    row = self.family.last_logits(w, toks[b], self.dims, self.family.fp8)
                    row = row.reshape(-1, V)[0]
                    served = torch.argmax(row)
                else:
                    row = r["logits"][b, :V].float()
                    served = r["served"][b].to(self.device)
                gaps = []
                for exact in rows.reshape(-1, V):
                    std = exact.std()
                    gaps.append((float((row - exact).abs().max() / std),
                                 float((exact.max() - exact[served.long()]) / std)))
                nearest = min(gaps)
                logit_gap = max(logit_gap, nearest[0])
                served_gap = max(served_gap, nearest[1])
        return {"served_gap": served_gap, "logit_gap": logit_gap}

    def check(self, iters) -> Dict[str, float]:
        return self.readings(iters)
