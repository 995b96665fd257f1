"""Batched LM serving engine: prefill + decode over any registry model
(port of ``repro.serve.engine``).

Static-batch decoding: requests share one prompt length, are prefilled
once, then decoded step by step with per-request EOS masking; finished
slots stop contributing (their tokens are frozen at 0).  Greedy
(``argmax``) or temperature sampling (the Gumbel-max draw that
``jax.random.categorical`` makes, from the ``torch.Generator`` the caller
passes).  The loop makes no host sync: every token stays on the device
until the caller reads the output.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    eos_id: Optional[int] = None


class Engine:
    def __init__(self, model, params, max_seq: int,
                 cfg: Optional[ServeConfig] = None):
        self.model = model
        self.params = params
        self.max_seq = max_seq
        self.cfg = cfg if cfg is not None else ServeConfig()

    def generate(self, prompts: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 extra: Optional[dict] = None,
                 n_new: Optional[int] = None) -> torch.Tensor:
        """prompts: (B, S_prompt) int -> (B, S_prompt + n_new) tokens.

        ``generator`` (on the prompts' device) drives temperature
        sampling; greedy decoding needs none.
        """
        b, s = prompts.shape
        n_new = n_new or self.cfg.max_new_tokens
        if s + n_new > self.max_seq:
            raise ValueError(f"prompt {s} + {n_new} new tokens exceed "
                             f"max_seq={self.max_seq}")
        if self.cfg.temperature > 0.0 and (
                generator is None or generator.device != prompts.device):
            raise ValueError("temperature sampling needs a torch.Generator "
                             f"on the prompts' device ({prompts.device})")
        batch = {"tokens": prompts, **(extra or {})}
        logits, cache = self.model.prefill(self.params, batch, max_seq=self.max_seq)
        out = prompts.new_empty((b, s + n_new))
        out[:, :s] = prompts
        done = torch.zeros((b,), dtype=torch.bool, device=prompts.device)
        tok = self._sample(logits, generator)
        offset = (self.model.cfg.n_vision_tokens
                  if self.model.cfg.family == "vlm" else 0)
        for i in range(n_new):
            tok = torch.where(done, 0, tok).to(prompts.dtype)
            out[:, s + i] = tok
            if self.cfg.eos_id is not None:
                done = done | (tok == self.cfg.eos_id)
            if i == n_new - 1:
                break
            logits, cache = self.model.decode(
                self.params, cache, {"tokens": tok[:, None], "pos": s + i + offset})
            tok = self._sample(logits, generator)
        return out

    def _sample(self, logits: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        # Gumbel-max: argmax(logits / T - log(-log(u))), u in [tiny, 1)
        u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
        return torch.argmax(logits.float() / self.cfg.temperature + gumbel, dim=-1)
