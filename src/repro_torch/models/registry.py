"""Model registry: ArchConfig -> a uniform Model object (port of
``repro.models.registry``).

``Model`` bundles what every launcher and test needs: parameter specs
(real init / abstract / logical axes), the three step functions (loss
value, prefill, decode), the cache structure, and
``input_specs``/``make_inputs`` for every input shape.  Two methods take
torch's explicit randomness where JAX's take a key:
``init_params(generator, device, dtype)`` and ``make_inputs(generator,
shape)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from . import encdec, transformer
from .common import abstract_tree, init_tree, logical_axes_tree, param_count


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    specs: Any

    # ---- params ----
    def init_params(self, generator: torch.Generator, device="cuda",
                    dtype=torch.float32):
        return init_tree(self.specs, generator, device, dtype)

    def abstract_params(self, dtype=torch.bfloat16):
        return abstract_tree(self.specs, dtype)

    def logical_axes(self):
        return logical_axes_tree(self.specs)

    def n_params(self) -> int:
        return param_count(self.specs)

    @property
    def _impl(self):
        return encdec if self.cfg.family == "encdec" else transformer

    # ---- step functions ----
    def loss(self, params, batch):
        return self._impl.loss_fn(params, batch, self.cfg)

    def prefill(self, params, batch, max_seq: int, cache_dtype=torch.bfloat16):
        return self._impl.prefill(params, batch, self.cfg, max_seq, cache_dtype)

    def decode(self, params, cache, batch):
        return self._impl.decode_step(params, cache, batch, self.cfg)

    def cache_structure(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                        abstract: bool = True, device="cuda"):
        return self._impl.cache_structure(self.cfg, batch, max_seq, dtype,
                                          abstract, device)

    # ---- inputs ----
    def input_specs(self, shape: ShapeConfig, act_dtype=torch.bfloat16) -> dict:
        """name -> (shape, dtype) of every model input of this shape (``pos``
        is a Python int: shape ())."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.phase == "train":
            batch = {"tokens": ((b, s), torch.int32), "labels": ((b, s), torch.int32)}
        elif shape.phase == "prefill":
            batch = {"tokens": ((b, s), torch.int32)}
        else:  # decode: one new token; the `s`-long context lives in the cache
            batch = {"tokens": ((b, 1), torch.int32), "pos": ((), torch.int32)}
        if cfg.family == "vlm" and shape.phase != "decode":
            batch["vision_embeds"] = ((b, cfg.n_vision_tokens, cfg.d_model), act_dtype)
        if cfg.family == "encdec" and shape.phase != "decode":
            batch["frames"] = ((b, cfg.enc_frames, cfg.d_model), act_dtype)
        return batch

    def make_inputs(self, generator: torch.Generator, shape: ShapeConfig,
                    act_dtype=torch.float32, device="cuda") -> dict:
        """Random inputs matching :meth:`input_specs`, drawn from
        ``generator`` (on its own device) and moved to ``device``."""
        out = {}
        for name, (s, dt) in self.input_specs(shape, act_dtype).items():
            if name in ("tokens", "labels"):
                out[name] = torch.randint(0, min(self.cfg.vocab, 1000), s,
                                          generator=generator, dtype=dt,
                                          device=generator.device).to(device)
            elif name == "pos":
                out[name] = shape.seq_len - 1
            else:
                out[name] = (0.02 * torch.randn(s, generator=generator, dtype=dt,
                                                device=generator.device)).to(device)
        return out

    def input_axes(self, shape: ShapeConfig) -> dict:
        """Logical axes for each input (for sharding rules)."""
        cfg = self.cfg
        if shape.phase == "decode":
            axes = {"tokens": ("batch", None), "pos": ()}
        else:
            axes = {"tokens": ("batch", "seq")}
            if shape.phase == "train":
                axes["labels"] = ("batch", "seq")
        if cfg.family == "vlm" and shape.phase != "decode":
            axes["vision_embeds"] = ("batch", None, "embed")
        if cfg.family == "encdec" and shape.phase != "decode":
            axes["frames"] = ("batch", None, "embed")
        return axes


def build_model(cfg: ArchConfig) -> Model:
    impl = encdec if cfg.family == "encdec" else transformer
    return Model(cfg=cfg, specs=impl.build_param_specs(cfg))
