"""Batched LM serving engine: prefill, then decode with greedy or
temperature sampling, shape-bucketed prompts and per-sequence stopping.

Port of ``src/repro/serve/engine.py`` over ``models.lm`` (the SSM family so
far). It mirrors the reference step for step:

* prompts are right-padded with token 0 up to ``buckets.bucket_dim(S)``,
  the serve-wide power-of-two grid, and the whole padded prompt is
  prefilled. The first new token comes from the logits of the last *padded*
  position, and with an SSM the pad tokens run through the recurrence and
  fold into its state, exactly as in the reference (ROADMAP.md queue 3);
* decode step i feeds the previous token at position ``S + i`` (the true
  prompt length), and ``max_new_tokens`` steps run, as there;
* ``temperature == 0`` samples by argmax. ``temperature > 0`` samples by the
  Gumbel-max trick from an explicit ``torch.Generator`` seeded with
  ``seed``: the same distribution as ``jax.random.categorical``, not the
  same draws (the two generators give different bits);
* ``eos_id >= 0``: once a sequence has emitted ``eos_id`` it emits only
  ``eos_id``.

One difference, on purpose: nothing grows the caches after the prefill.
The reference's ``_grow_seq`` pads the first cache axis whose size equals
the padded prompt length; an SSM cache has no sequence axis, so it pads a
head, state or batch axis instead whenever one of those sizes equals the
padded prompt length, and fails (smoke 2 x 12, full width 4 x 32). Caches
grow by layer kind, and an SSM layer's does not grow; the attention kinds,
whose K/V do, come with their slice.

The engine runs on the card unless built with ``device="cpu"``; its
parameters must already be there. Tokens stay on the device until the
last step and are read back once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.paralingam import _device
from repro_torch.models import lm
from repro_torch.serve.buckets import bucket_dim


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    eos_id: int = -1  # -1: never stop early


class Engine:
    def __init__(self, params, cfg, serve_cfg: ServeConfig | None = None, device=None):
        lm._check_ported(cfg)
        self.device = _device(device, "repro_torch.serve.engine.Engine")
        where = params["final_norm"].device
        if where.type != self.device.type:
            raise ValueError(f"the parameters are on {where}, the engine on {self.device}: "
                             "build them there (lm.init_params(..., device=...))")
        self.params = params
        self.cfg = cfg
        self.serve_cfg = serve_cfg or ServeConfig()

    def _sample(self, logits, gen):
        if self.serve_cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        scaled = logits.float() / self.serve_cfg.temperature
        u = torch.rand(scaled.shape, generator=gen, device=scaled.device)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        return torch.argmax(scaled - torch.log(-torch.log(u)), dim=-1)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, seed: int = 0) -> np.ndarray:
        """prompts: (B, S) int (right-padded with 0 is fine: bucketing pads S
        up to a power of two). Returns (B, max_new_tokens) int32. (The
        reference's encoder input comes with the encoder-decoder family.)"""
        scfg = self.serve_cfg
        b, s = prompts.shape
        prompts = np.pad(prompts, ((0, 0), (0, bucket_dim(s) - s)), constant_values=0)
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        last_logits, caches = lm.prefill(self.params, tokens, self.cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        pos = torch.full((b,), s, dtype=torch.int64, device=self.device)  # true prompt length
        out = []
        tok = self._sample(last_logits, gen)
        finished = torch.zeros((b,), dtype=torch.bool, device=self.device)
        for i in range(scfg.max_new_tokens):
            out.append(tok)
            logits, caches = lm.decode_step(self.params, tok, caches, pos + i, self.cfg)
            nxt = self._sample(logits, gen)
            if scfg.eos_id >= 0:
                finished = finished | (tok == scfg.eos_id)
                nxt = torch.where(finished, scfg.eos_id, nxt)
            tok = nxt
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
