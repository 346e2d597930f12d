"""Static-batch serving engine (port of ``repro/serve/engine.py:ServeEngine``).

One prefill fills a linear KV cache (a sliding-window ring with a window;
an RWKV model's recurrent state), then one decode step per generated
token.  A ragged batch (``prompt_lens``) takes each row's first token from
its own last prompt position and decodes in slot mode, each row from its
own cache position.  The continuous-batching engine is
``serve.continuous``.  Greedy when temperature == 0,
else temperature sampling from a
``torch.Generator`` seeded per call from (engine seed, call counter), so
keyless calls differ from each other and a fixed seed replays.  Rows that
emit ``eos_id`` / a stop token are frozen (pad tokens, 0.0 logprobs) and the
loop exits once every row has finished.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.models.api import ModelApi, resolve_device, slot_capable


@dataclasses.dataclass
class GenerationResult:
    tokens: torch.Tensor          # (B, max_new) — pad_id past each row's length
    logprobs: torch.Tensor        # (B, max_new) — 0.0 past each row's length
    prefill_len: int
    lengths: Optional[torch.Tensor] = None  # (B,) generated tokens per row,
                                            # stop token included
    prefill_ms: float = 0.0       # host clock, device synchronised
    decode_ms: float = 0.0        # all decode steps (sampling included)
    decode_steps: int = 0


class ServeEngine:
    def __init__(self, api: ModelApi, params, *, window=None,
                 temperature: float = 0.0, seed: int = 0, device=None):
        self.device = resolve_device(api.device if device is None else device)
        if self.device != api.device:
            raise ValueError(f"engine device {self.device} differs from the "
                             f"model's {api.device}")
        self.api = api
        self.params = params
        self.window = window
        self.temperature = temperature
        self.seed = seed
        self._n_calls = 0

    def _generator(self) -> torch.Generator:
        # one stream per (engine seed, call): repeated keyless calls differ
        state = np.random.SeedSequence([self.seed, self._n_calls]).generate_state(
            1, np.uint64)[0]
        return torch.Generator(device=self.device).manual_seed(int(state >> 1))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def generate(self, prompt_batch: dict, *, max_new_tokens: int,
                 capacity: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 eos_id: Optional[int] = None,
                 stop_tokens: Sequence[int] = (),
                 prompt_lens=None) -> GenerationResult:
        """prompt_batch: dict(tokens (B, S)) on the engine's device.
        ``prompt_lens`` (B,) marks the valid prefix of each left-aligned row
        of a ragged batch: row r's first token is sampled from position
        len_r - 1 and it decodes from cache position len_r (slot mode)."""
        tokens = prompt_batch["tokens"]
        b, s = tokens.shape
        cfg = self.api.cfg
        cap = (s + max_new_tokens + 8) if capacity is None else capacity
        window = cfg.sliding_window if self.window is None else self.window
        # an RWKV cache carries recurrent state, not positions, and a window's
        # ring holds the last W of them: no capacity to check
        if not cfg.rwkv and not window and cap < s + max_new_tokens:
            raise ValueError(
                f"KV cache capacity {cap} cannot hold prompt ({s}) + "
                f"max_new_tokens ({max_new_tokens}) = {s + max_new_tokens} "
                f"positions for {cfg.name}; pass capacity >= "
                f"{s + max_new_tokens} (or omit it)")
        if prompt_lens is not None:
            lens = torch.as_tensor(prompt_lens).to("cpu", torch.int32)
            if tuple(lens.shape) != (b,):
                raise ValueError(
                    f"prompt_lens shape {tuple(lens.shape)} != ({b},) for a "
                    f"batch of {b} prompts")
            if not slot_capable(cfg):
                raise ValueError(
                    f"prompt_lens needs per-request cache positions, which "
                    f"{cfg.name} (family={cfg.family}) does not support: "
                    f"recurrent/cross-attn state has no per-position layout")
            if window:
                raise ValueError(
                    f"prompt_lens is unsupported with a sliding-window ring "
                    f"cache (window={window}); serve {cfg.name} with "
                    f"window=0 or use serve.continuous (mask-windowed)")
            if (lens < 1).any() or (lens > s).any():
                raise ValueError(
                    f"prompt_lens must lie in [1, {s}] (got {lens.tolist()})")
        t0 = time.perf_counter()
        logits, cache = self.api.prefill(self.params, prompt_batch, None,
                                         capacity=cap, window=self.window)
        if prompt_lens is None:
            last_logits = logits[:, -1]
        else:
            # row r's first token comes from its own last prompt position, and
            # its decode stream starts at len_r: the per-row ``pos`` tensor
            # routes decode_step into slot mode
            lens = lens.to(self.device)
            last_logits = logits[torch.arange(b, device=self.device), lens.long() - 1]
            cache["pos"] = lens
        self._sync()
        t1 = time.perf_counter()
        if generator is None:
            generator = self._generator()
        self._n_calls += 1

        stop = [int(t) for t in stop_tokens]
        if eos_id is not None and int(eos_id) not in stop:
            stop.append(int(eos_id))
        pad_id = int(eos_id) if eos_id is not None else (stop[0] if stop else 0)
        stop_arr = torch.tensor(stop, dtype=torch.long, device=self.device) if stop else None
        finished = torch.zeros((b,), dtype=torch.bool, device=self.device)
        lengths = torch.zeros((b,), dtype=torch.int32, device=self.device)

        out_tokens: List[torch.Tensor] = []
        out_lp: List[torch.Tensor] = []
        steps = 0
        for _ in range(max_new_tokens):
            nxt = self._sample(last_logits, generator)
            nxt = torch.where(finished, torch.full_like(nxt, pad_id), nxt)
            lp = torch.log_softmax(last_logits.float(), dim=-1)
            lp = torch.gather(lp, 1, nxt[:, None])[:, 0]
            out_lp.append(torch.where(finished, torch.zeros_like(lp), lp))
            out_tokens.append(nxt)
            lengths += (~finished).to(torch.int32)
            if stop_arr is not None:
                finished = finished | torch.isin(nxt, stop_arr)
                if bool(finished.all()):
                    break
            logits_d, cache = self.api.decode_fn(self.params, cache,
                                                 {"tokens": nxt[:, None]},
                                                 None, window=self.window)
            last_logits = logits_d[:, -1]
            steps += 1
        self._sync()
        t2 = time.perf_counter()
        n_pad = max_new_tokens - len(out_tokens)
        if n_pad:
            out_tokens += [torch.full((b,), pad_id, dtype=torch.long,
                                      device=self.device)] * n_pad
            out_lp += [torch.zeros((b,), dtype=torch.float32,
                                   device=self.device)] * n_pad
        return GenerationResult(
            tokens=torch.stack(out_tokens, dim=1),
            logprobs=torch.stack(out_lp, dim=1),
            prefill_len=s, lengths=lengths,
            prefill_ms=(t1 - t0) * 1e3, decode_ms=(t2 - t1) * 1e3,
            decode_steps=steps)

    def _sample(self, logits, generator):
        if self.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
