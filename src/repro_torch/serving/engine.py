"""Serving engine: continuous batching over the Tidehunter KV-WAL.

The host side plays the paper's *asynchronous controller* role (§3.1): it
allocates per-slot sequences, tracks which KV-WAL segments (blocks) are fully
expired, and recycles them — the device never copies a KV byte.  Requests are
queued, admitted into free batch slots, decoded step by step with greedy or
temperature sampling, and retired on EOS or length budget; retirement is an
epoch event: all the sequence's blocks expire at once.

This is the JAX package's ``ServingEngine`` (``repro/serving/engine.py``)
for the dense family.  Greedy decoding picks the same tokens as the JAX
engine's; temperature sampling draws from a ``torch.Generator`` seeded from
``seed`` and so draws other tokens than JAX's generator.  The storage-side
``KvBatchServer`` lives in ``kv_server`` (it needs neither PyTorch nor the
model stack) and is re-exported here, where the JAX package has it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import serve as serve_mod
from repro_torch.models.base import ModelConfig
from repro_torch.models.convert import cast_weights
from repro_torch.models.transformer import DENSE_FAMILIES, require_family
from repro_torch.serving.kv_server import KvBatchServer, KvRead, KvWrite

__all__ = ["Request", "ServingEngine", "KvBatchServer", "KvRead", "KvWrite"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # (len,) int32
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = dataclasses.field(default_factory=time.time)
    t_done: Optional[float] = None


class ServingEngine:
    """Batched decode over a fixed slot count (continuous batching).

    ``device`` defaults to ``"cuda"``, where every decode step runs the
    ``tide_attention`` kernel, and the engine refuses to start without a
    card; ``device="cpu"`` runs the kernel's plain version instead.  The
    engine holds the matrix weights cast once to ``cfg.adtype`` — the
    values the JAX package casts them to at every use — which halves
    Llama-3-8B's 32 GB of fp32 weights; norm scales stay in ``cfg.pdtype``.

    ``prefill_s`` and ``decode_s`` sum the host time of prefills and decode
    steps, each of which ends in a copy of its tokens to the host.
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 max_seq: int = 256, seed: int = 0, device: str = "cuda"):
        if torch.device(device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                f"ServingEngine(device={device!r}) needs a CUDA card and none "
                f"is available; pass device='cpu' to run the kernel's plain "
                f"version on the host")
        require_family(cfg, DENSE_FAMILIES,
                       "the serving engine (KV-WAL families only)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.params = cast_weights(params, cfg.adtype, self.device)
        self.slots = batch_slots
        self.max_seq = max_seq
        self.queue: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}        # slot -> request
        self._retired_sink: Optional[list] = None   # set by run_until_drained
        self.cache = serve_mod.init_cache(cfg, batch_slots, max_seq,
                                          self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.segments_recycled = 0
        self.prefills = self.decode_steps = 0
        self.prefill_s = self.decode_s = 0.0

    # ------------------------------------------------------------- client
    def submit(self, prompt, max_new_tokens: int = 32, eos_id=None,
               temperature: float = 0.0) -> Request:
        req = Request(rid=len(self.queue) + len(self.active) + 1,
                      prompt=np.asarray(prompt, np.int32),
                      max_new_tokens=max_new_tokens, eos_id=eos_id,
                      temperature=temperature)
        self.queue.append(req)
        return req

    # -------------------------------------------------------------- admit
    def _admit(self) -> None:
        for slot in range(self.slots):
            if slot in self.active or not self.queue:
                continue
            req = self.queue.popleft()
            self._prefill_into_slot(slot, req)
            self.active[slot] = req

    @torch.no_grad()
    def _prefill_into_slot(self, slot: int, req: Request) -> None:
        """Write the prompt's KV entries into the slot's arena region.

        Single-sequence prefill into a one-slot cache, then splice the
        slot's arena rows into the engine cache in place (the JAX engine's
        ``.at[:, slot].set``).  Append-once: rows are written at their final
        position; they will never move."""
        t0 = time.perf_counter()
        prompt = torch.from_numpy(req.prompt[None, :]).to(self.device)
        logits, c1 = serve_mod.prefill(self.params, self.cfg,
                                       {"tokens": prompt}, self.max_seq)
        for key in ("arena_k", "arena_v"):
            self.cache[key][:, slot] = c1[key][:, 0]
        self.cache["seq_lens"][slot] = len(req.prompt)
        self.cache["first_live"][slot] = 0
        req.out_tokens.append(self._sample(logits[0], req))
        self.prefills += 1
        self.prefill_s += time.perf_counter() - t0

    def _sample(self, logits: torch.Tensor, req: Request) -> int:
        if req.temperature <= 0:
            return int(torch.argmax(logits))
        probs = torch.softmax(logits.float() / req.temperature, dim=-1)
        return int(torch.multinomial(probs, 1, generator=self.gen))

    # --------------------------------------------------------------- step
    @torch.no_grad()
    def step(self) -> int:
        """One engine iteration: admit, decode one token for every active
        slot, retire finished requests + recycle their segments."""
        self._admit()
        if not self.active:
            return 0
        t0 = time.perf_counter()
        tokens = np.zeros((self.slots,), np.int32)
        for slot, req in self.active.items():
            tokens[slot] = req.out_tokens[-1]
        logits, self.cache = serve_mod.decode_step(
            self.params, self.cfg, self.cache,
            torch.from_numpy(tokens).to(self.device))
        greedy = torch.argmax(logits, dim=-1).tolist()
        finished = []
        for slot, req in self.active.items():
            tok = (greedy[slot] if req.temperature <= 0
                   else self._sample(logits[slot], req))
            req.out_tokens.append(tok)
            over = len(req.out_tokens) >= req.max_new_tokens
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if over or hit_eos:
                finished.append(slot)
        self.decode_steps += 1
        self.decode_s += time.perf_counter() - t0
        for slot in finished:
            self._retire(slot)
        return len(self.active) + len(finished)

    def _retire(self, slot: int) -> None:
        """Request completion = epoch expiry: every block of the slot dies
        at once; the slot is recycled without moving any bytes."""
        req = self.active.pop(slot)
        req.done = True
        req.t_done = time.time()
        if self._retired_sink is not None:
            self._retired_sink.append(req)
        blocks_used = -(-int(self.cache["seq_lens"][slot]) // self.cfg.kv_block)
        self.segments_recycled += blocks_used
        self.cache["seq_lens"][slot] = 0
        self.cache["first_live"][slot] = 0

    def run_until_drained(self, max_steps: int = 10_000) -> list[Request]:
        """Step until idle; returns the requests retired during this call
        in completion order (nothing is retained after the call returns)."""
        done: list[Request] = []
        prev_sink, self._retired_sink = self._retired_sink, done
        try:
            steps = 0
            while (self.queue or self.active) and steps < max_steps:
                self.step()
                steps += 1
        finally:
            self._retired_sink = prev_sink
        return done
