"""Batched LM serving engine: prefill, then decode with greedy or
temperature sampling, shape-bucketed prompts and per-sequence stopping.

Port of ``src/repro/serve/engine.py`` over ``models.lm`` (the decoder-only
families: dense attention, sliding-window, MLA and MoE, SSM and hybrid). It
mirrors the reference step for step:

* with ``bucket_prompts`` (the default) prompts are right-padded with token
  0 up to ``buckets.bucket_dim(S)``, the serve-wide power-of-two grid, and
  the whole padded prompt is prefilled. The first new token comes from the
  logits of the last *padded* position; with an SSM the pad tokens run
  through the recurrence and fold into its state, exactly as in the
  reference (ROADMAP.md queue 3);
* decode step i feeds the previous token at position ``S + i`` (the true
  prompt length): an attention layer writes its K/V (an MLA layer its
  c_kv and k_rope) there, over a pad token's, and attends to positions ``t < S + i + 1``, so the K/V of the
  pad tokens past that point stay masked, as in the reference;
* ``max_new_tokens`` steps run, as there;
* ``temperature == 0`` samples by argmax. ``temperature > 0`` samples by the
  Gumbel-max trick from an explicit ``torch.Generator`` seeded with
  ``seed``: the same distribution as ``jax.random.categorical``, not the
  same draws (the two generators give different bits);
* ``eos_id >= 0``: once a sequence has emitted ``eos_id`` it emits only
  ``eos_id``.

One difference, on purpose: the caches grow by layer kind
(``lm.prefill(..., max_seq=)``). Every attention
layer's K/V and every MLA layer's c_kv and k_rope, the prologue's too,
grow to the padded prompt plus ``max_new_tokens``; an SSM layer's cache has
no sequence axis and does not grow. The reference's ``_grow_seq`` pads the
first cache axis whose size equals the padded prompt length; an SSM cache
has no sequence axis, so it pads a head, state or batch axis instead
whenever one of those sizes equals the padded prompt length, and fails
(mamba2 at smoke 2 x 12 and full width 4 x 32; zamba2); a stacked MLA cache
(G, B, S, r) has its batch axis first, so it pads that when B equals the
padded prompt length.

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
    bucket_prompts: bool = True


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
        if scfg.bucket_prompts:
            prompts = np.pad(prompts, ((0, 0), (0, bucket_dim(s) - s)), constant_values=0)
        total = prompts.shape[1] + scfg.max_new_tokens
        tokens = torch.as_tensor(np.asarray(prompts, np.int64), device=self.device)
        last_logits, caches = lm.prefill(self.params, tokens, self.cfg, max_seq=total)
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
