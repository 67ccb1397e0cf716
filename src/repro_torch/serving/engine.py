"""Serving: prefill/decode steps and a batched continuous-batching scheduler.

``make_serve_step(cfg)`` returns the one-token decode step: given a KV
cache covering ``seq_len`` context (or the recurrent states), decode
exactly one new token per sequence, for every family the port has: dense,
MoE, SSM, hybrid, audio and VLM.  The engine prefills token by token
through that step, as the JAX package's engine does, so it never reaches
the full-sequence flash-attention kernel K5; with the SSM family under
``attn_impl="pallas"`` every step runs K6, K7 and K8.

The engine reproduces the JAX package's, including two behaviours of
its (ROADMAP.md, R7 and R8):

* R7: every lockstep step decodes a dummy token 0 in each slot that is
  not being prefilled or decoded, and a slot's state is not reset when a
  request is admitted.  A KV slot's dummy write is overwritten by its
  next real token; a recurrent slot's state (the SSM's conv and scan
  states, the hybrid's conv and LRU states) advances on the dummy token,
  and a reused slot starts from the last request's state.  So with those
  families a stream served beside others, or in a reused slot, may
  differ from the same request served alone in a fresh engine.
* R8: the cache comes from ``init_cache`` and only ``decode_step`` ever
  writes it, so whisper's cross k/v stay zero (no encoder runs) and
  paligemma's vision-prefix slots stay empty (no patches are seen) while
  a request is served.  Both are attended as they are.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

from repro_torch.core.kernels_xp import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, cache, tokens (B,1), index) -> (cache, next_tokens)."""

    def serve_step(model, cache, tokens, index):
        cache, logits = T.decode_step(model, cfg, cache, tokens, index)
        return cache, logits[:, -1].argmax(dim=-1)

    return serve_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(model, cache, batch):
        cache, logits = T.prefill(model, cfg, batch, cache)
        return cache, logits[:, -1].argmax(dim=-1)

    return prefill_step


# --------------------------------------------------------------------------- #
# Minimal continuous-batching engine
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


class BatchedEngine:
    """Fixed-slot continuous batching: finished requests release their slot,
    waiting requests are admitted, all slots decode in lockstep (the standard
    serving dataflow).  The model must lie on ``device``; the KV cache is
    allocated there."""

    def __init__(self, model: T.Model, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 256, device="cuda"):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"runs on {self.device}")
        self.model = model
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.cache = T.init_cache(cfg, slots, max_len, device=model.device)
        self.active: Dict[int, Request] = {}
        self.slot_of: Dict[int, int] = {}
        self.free = list(range(slots))
        self.pos = [0] * slots
        self.queue: List[Request] = []
        self._decode = make_serve_step(cfg)

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _step(self, tokens: List[int], positions: List[int]) -> List[int]:
        dev = self.model.device
        tok = torch.tensor(tokens, dtype=torch.long, device=dev)[:, None]
        idx = torch.tensor(positions, dtype=torch.long, device=dev)
        self.cache, nxt = self._decode(self.model, self.cache, tok, idx)
        return nxt.tolist()

    def _admit(self) -> None:
        while self.queue and self.free:
            req = self.queue.pop(0)
            slot = self.free.pop(0)
            self.active[req.rid] = req
            self.slot_of[req.rid] = slot
            # prefill this slot token-by-token (keeps one decode code path);
            # an empty prompt is padded with token 0 so there is always a
            # last-token logit to sample the first generated token from
            toks = req.prompt if req.prompt else [0]
            nxt = None
            for i, t in enumerate(toks):
                tok = [0] * self.slots
                tok[slot] = t
                idx = list(self.pos)
                # other slots decode a dummy token at their own next position;
                # a KV write is overwritten by their next real token, an SSM
                # state is not (module docstring, R7)
                idx[slot] = i
                nxt = self._step(tok, idx)
            self.pos[slot] = len(toks)
            req.generated.append(nxt[slot])

    def step(self) -> List[Tuple[int, int]]:
        """One lockstep decode over all active slots; returns (rid, token)."""
        self._admit()
        if not self.active:
            return []
        # per-slot position vector: each slot decodes at its own context
        # length, so staggered admissions keep independent KV positions
        tok = [0] * self.slots
        for rid, req in self.active.items():
            tok[self.slot_of[rid]] = req.generated[-1]
        nxt = self._step(tok, self.pos)
        out = []
        finished = []
        for rid, req in list(self.active.items()):
            slot = self.slot_of[rid]
            t = nxt[slot]
            req.generated.append(t)
            self.pos[slot] += 1
            out.append((rid, t))
            if req.done or self.pos[slot] >= self.max_len - 1:
                finished.append(rid)
        for rid in finished:
            slot = self.slot_of.pop(rid)
            self.active.pop(rid)
            self.free.append(slot)
            self.pos[slot] = 0
        return out

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        steps = 0
        while (self.active or self.queue) and steps < max_steps:
            self.step()
            steps += 1
