"""A decode pool: a fixed batch of sequences whose prompts the port's own
prefill writes into one KV cache during set-up, in sub-batches; then the
window drives the port's ``make_serve_step`` step after step, greedy, every
sequence one token a step, each step ending in a device sync as
``launch/serve_lm.generate`` does.  When the cache is full the pool starts
its round again from the prompts (the cache's positions past the prompt
are written anew).

The check samples sequences drawn from the seed and holds every token
served to them in the first round to the plain reference's logits over the
prompt and the tokens before it.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

import harness
import traffic
import weights
from reference import decoder as ref


class Driver(harness.Driver):
    def setup(self) -> None:
        from repro_torch.launch.steps import make_prefill_step, make_serve_step
        from repro_torch.models import model_zoo

        mix, V = self.mix, self.dims.vocab_size
        N, P = mix["sequences"], mix["prompt_len"]
        self.params = weights.tree_of(weights.make_flat(self.dims, self.seed, self.device))
        self.cache = model_zoo.init_cache(self.cfg, N, mix["max_len"], device=self.device)
        self.prompts = traffic.prompts(self.seed, 0, N, P, V, self.device)
        prefill = make_prefill_step(self.cfg)
        first = []
        for lo in range(0, N, mix["prefill_batch"]):
            hi = min(lo + mix["prefill_batch"], N)
            part = _rows(self.cache, lo, hi)
            logits, _ = prefill(self.params, {"tokens": self.prompts[lo:hi]}, part)
            first.append(torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None])
        self.first = torch.cat(first)
        self.serve = make_serve_step(self.cfg)
        self.round = [self.first]  # the tokens served in the first round
        self.cur, self.cache_len, self.rounds = self.first, P, 1
        self._step()  # warms the step's shapes: the round's second token

    def _step(self) -> None:
        self.cur, self.cache = self.serve(self.params, self.cur, self.cache, self.cache_len)
        harness.sync(self.device)
        if self.rounds == 1:
            self.round.append(self.cur)
        self.cache_len += 1
        if self.cache_len == self.mix["max_len"]:
            self.cur, self.cache_len = self.first, self.mix["prompt_len"]
            self.rounds += 1

    def call(self, i: int) -> dict:
        cache_len = self.cache_len
        t0 = time.perf_counter()
        self._step()
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "cache_len": cache_len, "requests": self.mix["sequences"]}

    def release(self) -> None:
        del self.params, self.cache, self.serve
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def gaps(self, control: bool = False) -> torch.Tensor:
        served = torch.cat(self.round, dim=1)  # (N, n + 1)
        w = weights.make_flat(self.dims, self.seed, self.device)
        P, n = self.mix["prompt_len"], served.shape[1] - 1
        out = []
        for s in traffic.sample(self.seed, 3, self.mix["sequences"], self.mix["check_sequences"]):
            toks = torch.cat([self.prompts[s], served[s, :n]])
            out.append(ref.served_gaps(w, toks, range(P - 1, P + n), served[s], self.dims,
                                       control=control))
        return torch.cat(out)

    def check(self, iters) -> Dict[str, float]:
        return {"served_gap": float(self.gaps().max())}


def _rows(cache, lo: int, hi: int):
    """The cache tree restricted to sequences [lo, hi): views, so the
    prefill's writes land in the pool's cache."""

    if isinstance(cache, dict):
        return {k: _rows(v, lo, hi) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_rows(v, lo, hi) for v in cache]
    return cache[lo:hi]
