"""Serving substrate: prefill + decode step builders and the greedy
generation loop (the port of ``repro/serve/engine.py``).

One card: the reference's ``ParallelCtx`` (sharding constraints, the
mesh) has no counterpart here yet and the builders take none.  Decode
updates the cache in place, as the reference's donated cache does on its
device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_len: int
    window: Any = "cfg"       # "cfg" or explicit int/None (long-context cells)
    # Copied from the reference, which never reads it (its serve path runs
    # the parameters in whatever dtype they were made); neither does the port.
    param_dtype: str = "bfloat16"


def build_prefill(cfg: ModelConfig, scfg: ServeConfig):
    def prefill_fn(model, tokens, prefix=None, frames=None):
        return T.prefill(cfg, model, tokens, prefix=prefix, frames=frames,
                         max_len=scfg.max_len, window=scfg.window)

    return prefill_fn


def build_decode(cfg: ModelConfig, scfg: ServeConfig):
    def decode_fn(model, token, cache, pos):
        return T.decode_step(cfg, model, token, cache, pos, window=scfg.window)

    return decode_fn


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def greedy_generate(cfg: ModelConfig, model, prompt: torch.Tensor, steps: int,
                    scfg: ServeConfig, prefix: torch.Tensor | None = None,
                    frames: torch.Tensor | None = None, temperature: float = 0.0,
                    generator: torch.Generator | None = None,
                    trace: dict | None = None) -> torch.Tensor:
    """Generation loop (host-driven): prefill the prompt (B, S) after the
    VLM ``prefix`` (B, P, d), with an encoder-decoder's ``frames`` (B, Fs,
    d), then ``steps − 1`` decode steps.  Returns the ``steps`` sampled
    tokens (B, steps).  Greedy unless ``temperature`` > 0 and a
    ``generator`` is given.  ``scfg.max_len`` must cover the prefix, the
    prompt and the steps (the reference's caller adds ``prefix_len``).

    ``trace``, when given, receives each step's logits (``logits``, the
    prefill's first) and the host time of the prefill and of all decode
    steps (``prefill_s``, ``decode_s``, the card synchronised at each
    end)."""
    prefill_fn = build_prefill(cfg, scfg)
    decode_fn = build_decode(cfg, scfg)
    _sync(prompt)
    t0 = time.perf_counter()
    logits, cache, pos = prefill_fn(model, prompt, prefix, frames)
    tok = _sample(logits, temperature, generator, cfg.vocab)
    _sync(prompt)
    t1 = time.perf_counter()
    toks, all_logits = [tok], [logits]
    for i in range(steps - 1):
        logits, cache = decode_fn(model, tok[:, None], cache, pos + i)
        tok = _sample(logits, temperature, generator, cfg.vocab)
        toks.append(tok)
        all_logits.append(logits)
    _sync(prompt)
    if trace is not None:
        trace.update(logits=all_logits, prefill_s=t1 - t0, decode_s=time.perf_counter() - t1)
    return torch.stack(toks, dim=1)


def _sample(logits: torch.Tensor, temperature: float, generator: torch.Generator | None,
            vocab: int) -> torch.Tensor:
    logits = logits[..., :vocab]
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[..., 0]
