"""Batched serving driver, the counterpart of the reference's
``examples/serve_lm.py``: prefill a prompt batch, then greedy-decode with
the KV cache through the step functions of :mod:`repro_torch.launch.steps`.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch yi_6b --tokens 32
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu

It runs the smoke-size configuration of ``--arch`` on ``--device``
(``cuda`` unless the caller asks for ``cpu``); :func:`generate` is the loop,
which ``chip_smoke.py`` drives at full size.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.compile.lowering import resolve_device
from repro_torch.configs import ARCHITECTURES, get_smoke_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import model_zoo as zoo


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, new_tokens) int32, greedy
    prefill_logits: torch.Tensor  # (B, 1, padded vocab), last position
    prefill_ms: float             # host clock, ending in a device sync
    decode_ms: List[float]        # per decode step, likewise

    @property
    def decode_ms_total(self) -> float:
        return sum(self.decode_ms)


def prefix_len(cfg: ModelConfig) -> int:
    return cfg.num_patches if cfg.frontend == "vision" else 0


def make_batch(
    cfg: ModelConfig, batch: int, prompt_len: int, *, device="cuda", seed: int = 0
) -> Dict[str, torch.Tensor]:
    """Random prompts (and frame embeddings for the audio stub, patch
    embeddings for the vision stub), drawn from a seeded generator on
    ``device``."""

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {
        "tokens": torch.randint(
            0, cfg.vocab_size, (batch, prompt_len), generator=gen, device=dev,
            dtype=torch.int32,
        )
    }
    if cfg.frontend == "audio":
        out["frame_embeds"] = torch.randn(
            (batch, cfg.encoder.num_frames, cfg.d_model), generator=gen, device=dev
        )
    if cfg.frontend == "vision":
        out["patch_embeds"] = 0.1 * torch.randn(
            (batch, cfg.num_patches, cfg.d_model), generator=gen, device=dev
        )
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(
    params: dict,
    cfg: ModelConfig,
    batch: Dict[str, torch.Tensor],
    new_tokens: int,
    *,
    cache: Optional[dict] = None,
) -> ServeResult:
    """Prefill ``batch``, then ``new_tokens - 1`` greedy decode steps.

    ``cache`` (optional) is a cache from :func:`zoo.init_cache` with room
    for the prompt, the prefix and ``new_tokens``; it is zeroed and then
    overwritten, so one cache can serve wave after wave of the same shape
    (a Mamba layer's prefill starts from the state the cache holds).
    """

    if new_tokens < 1:
        raise ValueError(f"new_tokens must be at least 1, got {new_tokens}")
    tokens = batch["tokens"]
    dev = tokens.device
    B, S = tokens.shape
    cache_len = S + prefix_len(cfg)
    if cache is None:
        cache = zoo.init_cache(cfg, B, cache_len + new_tokens, device=dev)
    else:
        for t in tree_lib.leaves(cache):
            t.zero_()
    prefill = make_prefill_step(cfg)
    serve = make_serve_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch, cache)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3

    cur = torch.argmax(logits[:, -1, :], dim=-1)[:, None].to(torch.int32)
    generated = [cur]
    decode_ms = []
    for _ in range(new_tokens - 1):
        t0 = time.perf_counter()
        cur, cache = serve(params, cur, cache, cache_len)
        _sync(dev)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        cache_len += 1
        generated.append(cur)
    return ServeResult(
        tokens=torch.cat(generated, dim=1),
        prefill_logits=logits,
        prefill_ms=prefill_ms,
        decode_ms=decode_ms,
    )


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi_6b", choices=ARCHITECTURES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch)
    params = zoo.init(cfg, device=args.device, seed=args.seed)
    batch = make_batch(
        cfg, args.batch, args.prompt_len, device=args.device, seed=args.seed
    )
    res = generate(params, cfg, batch, args.tokens)

    total = args.batch * args.tokens
    t_decode = res.decode_ms_total / 1e3
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} device={args.device}")
    print(f"prefill: {res.prefill_ms:.1f} ms")
    print(
        f"decode:  {args.tokens - 1} steps in {res.decode_ms_total:.1f} ms "
        f"({total / max(t_decode, 1e-9):.0f} tok/s batched)"
    )
    print("sample token ids:", res.tokens[0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
