"""Continuous-batching request scheduler over the paged-KV serve steps.

One :class:`PagedServeEngine` owns a fixed grid of B batch slots, the
paged KV pools (``core/kv_cache.py``) and the three step functions of
its bundle:

  - a chunked-prefill step ([B, chunk] tokens; long prompts advance one
    chunk per scheduler iteration so they never stall in-flight decodes)
  - a paged decode step ([B, 1] tokens)
  - the greedy pick

Every scheduler iteration:

  admit   -> pop FIFO requests into FREE slots while their full page
             reservation (ceil((prompt+max_new)/page_size)) fits the
             free list -- conservative, so an admitted sequence can
             never be starved mid-decode (no preemption)
  prefill -> one chunk for every PREFILL slot (rows not prefilling ride
             along against the scratch page); a slot whose prompt
             completes emits its first token (TTFT) and turns DECODE
  decode  -> one token for every DECODE slot; finished slots retire,
             their pages return to the free list and their table row
             resets to scratch

``policy="static"`` keeps the same steps but admits only whole waves
(wait for every slot to drain, then refill) -- the wait-for-full-batch
baseline.

All timing is wall-clock: token picks are copied to the host (which
waits for the device) before timestamps, so TTFT/ITL include device
time.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.kv_cache import PagedKVConfig, PageAllocator

FREE, PREFILL, DECODE = 0, 1, 2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                  # [plen] int32 token ids
    max_new_tokens: int


@dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_first: float = 0.0                # first generated token (TTFT end)
    t_done: float = 0.0
    itl: List[float] = field(default_factory=list)   # inter-token gaps (s)

    @property
    def ttft(self) -> float:
        return self.t_first - self.t_submit

    @property
    def tpot(self) -> float:
        """Time per output token after the first."""
        n = len(self.tokens)
        return (self.t_done - self.t_first) / max(n - 1, 1)


def _pcts(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p90": 0.0, "p99": 0.0}
    a = np.asarray(xs, np.float64)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99))}


def summarize(results: List[RequestResult], wall_s: float) -> Dict:
    """Request throughput + TTFT/TPOT/ITL percentiles (seconds)."""
    n_tok = sum(len(r.tokens) for r in results)
    return {
        "requests": len(results),
        "generated_tokens": n_tok,
        "wall_s": wall_s,
        "throughput_rps": len(results) / wall_s if wall_s > 0 else 0.0,
        "throughput_tok_s": n_tok / wall_s if wall_s > 0 else 0.0,
        "ttft_s": _pcts([r.ttft for r in results]),
        "tpot_s": _pcts([r.tpot for r in results]),
        "itl_s": _pcts([g for r in results for g in r.itl]),
    }


def _host_array(t: torch.Tensor) -> np.ndarray:
    """Copy a device tensor to a numpy array (waits for the device);
    bf16, which numpy lacks, widens to fp32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class PagedServeEngine:
    """Multi-request serving over one StepBundle (decode cell)."""

    def __init__(self, bundle, kv: PagedKVConfig, chunk: int = 32,
                 policy: str = "continuous", capture_logits: bool = False):
        from repro_torch.core.engine.serve import paged_replicas
        if policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {policy!r}")
        cell = bundle.run.shape
        self.bundle = bundle
        self.device = bundle.device
        self.kv = kv
        self.chunk = min(chunk, kv.max_seq_len)
        self.policy = policy
        self.capture_logits = capture_logits
        self.B = cell.global_batch
        self.n_replicas = paged_replicas(bundle, cell)
        self.slots_per_rep = self.B // self.n_replicas
        self.allocs = [PageAllocator(kv) for _ in range(self.n_replicas)]
        self._prefill = bundle.make_prefill_chunk_step(kv)
        self._decode = bundle.make_paged_decode_step(kv)
        self._pick = bundle.make_greedy_pick()
        self.state = bundle.init_paged_state(kv)
        # host-side slot metadata
        self.table = np.zeros((self.B, kv.max_pages_per_seq), np.int32)
        self.lengths = np.zeros((self.B,), np.int32)
        self.status = np.full((self.B,), FREE, np.int32)
        self.prefilled = np.zeros((self.B,), np.int32)
        self.last_tok = np.zeros((self.B,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * self.B
        self.slot_res: List[Optional[RequestResult]] = [None] * self.B
        self.slot_pages: List[List[int]] = [[] for _ in range(self.B)]
        self.slot_tlast = np.zeros((self.B,), np.float64)
        self.captured: Dict[int, List[np.ndarray]] = {}
        self.steps = 0
        self.prefill_calls = 0
        self.decode_calls = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # -- admission -----------------------------------------------------------
    def _replica_of(self, slot: int) -> int:
        return slot // self.slots_per_rep

    def _admit(self, queue: deque) -> None:
        if self.policy == "static":
            # wait-for-full-batch: refill only once every slot drained
            if (self.status != FREE).any() or not queue:
                return
        while queue:
            req = queue[0]
            need = self.kv.pages_needed(len(req.prompt)
                                        + req.max_new_tokens)
            placed = False
            for s in range(self.B):
                if self.status[s] != FREE:
                    continue
                pages = self.allocs[self._replica_of(s)].alloc(need)
                if pages is None:
                    continue
                queue.popleft()
                self.slot_pages[s] = pages
                self.table[s, :] = 0
                self.table[s, :len(pages)] = pages
                self.lengths[s] = 0
                self.prefilled[s] = 0
                self.status[s] = PREFILL
                self.slot_req[s] = req
                self.slot_res[s] = RequestResult(
                    rid=req.rid, prompt_len=len(req.prompt),
                    t_submit=self._t_submit[req.rid])
                placed = True
                break
            if not placed:
                break               # FIFO: head of line blocks admission

    def _retire(self, s: int, tnow: float) -> None:
        res = self.slot_res[s]
        res.t_done = tnow
        self.results.append(res)
        self.allocs[self._replica_of(s)].free(self.slot_pages[s])
        self.slot_pages[s] = []
        self.table[s, :] = 0        # back to scratch
        self.lengths[s] = 0
        self.status[s] = FREE
        self.slot_req[s] = None
        self.slot_res[s] = None

    # -- one scheduler iteration --------------------------------------------
    def _prefill_step(self, params) -> None:
        pf = np.nonzero(self.status == PREFILL)[0]
        if len(pf) == 0:
            return
        C = self.chunk
        ids = np.zeros((self.B, C), np.int32)
        ptab = np.zeros_like(self.table)     # scratch for non-participants
        pos0 = np.zeros((self.B,), np.int32)
        last = np.zeros((self.B,), np.int32)
        took = {}
        for s in pf:
            req = self.slot_req[s]
            start = int(self.prefilled[s])
            n = min(C, len(req.prompt) - start)
            ids[s, :n] = req.prompt[start:start + n]
            ptab[s] = self.table[s]
            pos0[s] = start
            last[s] = n - 1
            took[s] = n
        logits, self.state = self._prefill(
            params, self._dev(ids), self._dev(ptab), self._dev(pos0),
            self._dev(last), self.state)
        self.prefill_calls += 1
        completing = [s for s in pf
                      if self.prefilled[s] + took[s]
                      >= len(self.slot_req[s].prompt)]
        if not completing:
            # mid-prompt chunk: no slot emits a token, so skip the pick
            # and the host sync
            for s in pf:
                self.prefilled[s] += took[s]
            return
        toks = _host_array(self._pick(logits))          # waits
        tnow = time.perf_counter()
        full_logits = _host_array(logits) if self.capture_logits else None
        for s in pf:
            req = self.slot_req[s]
            self.prefilled[s] += took[s]
            if self.prefilled[s] < len(req.prompt):
                continue
            # prompt complete: first generated token comes from the
            # last prompt token's logits in this chunk
            self.lengths[s] = len(req.prompt)
            self.status[s] = DECODE
            res = self.slot_res[s]
            res.t_first = tnow
            res.tokens.append(int(toks[s]))
            self.last_tok[s] = toks[s]
            self.slot_tlast[s] = tnow
            if full_logits is not None:
                self.captured.setdefault(req.rid, []).append(
                    full_logits[s].copy())
            if req.max_new_tokens == 1:
                self._retire(s, tnow)

    def _decode_step(self, params) -> None:
        dc = np.nonzero(self.status == DECODE)[0]
        if len(dc) == 0:
            return
        toks_in = np.zeros((self.B, 1), np.int32)
        dtab = np.zeros_like(self.table)     # scratch for non-decoding rows
        for s in dc:
            toks_in[s, 0] = self.last_tok[s]
            dtab[s] = self.table[s]
        logits, self.state = self._decode(
            params, self._dev(toks_in), self._dev(dtab),
            self._dev(self.lengths), self.state)
        self.decode_calls += 1
        toks = _host_array(self._pick(logits))          # waits
        tnow = time.perf_counter()
        full_logits = _host_array(logits) if self.capture_logits else None
        for s in dc:
            req = self.slot_req[s]
            res = self.slot_res[s]
            if full_logits is not None:
                self.captured.setdefault(req.rid, []).append(
                    full_logits[s].copy())
            self.lengths[s] += 1             # the incoming token's kv landed
            res.tokens.append(int(toks[s]))
            res.itl.append(tnow - self.slot_tlast[s])
            self.slot_tlast[s] = tnow
            self.last_tok[s] = toks[s]
            if len(res.tokens) >= req.max_new_tokens:
                self._retire(s, tnow)

    # -- run loop ------------------------------------------------------------
    def serve(self, params, requests: List[Request]):
        """Run all requests to completion. Returns (results, wall_s);
        results are ordered by completion time."""
        for r in requests:
            total = len(r.prompt) + r.max_new_tokens
            if total > self.kv.max_seq_len:
                raise ValueError(
                    f"request {r.rid}: prompt+max_new {total} exceeds "
                    f"max_seq_len {self.kv.max_seq_len}")
            if self.kv.pages_needed(total) > self.kv.pages_per_replica - 1:
                raise ValueError(
                    f"request {r.rid} can never fit the per-replica pool")
        queue = deque(requests)
        self.results: List[RequestResult] = []
        t0 = time.perf_counter()
        self._t_submit = {r.rid: t0 for r in requests}
        while queue or (self.status != FREE).any():
            self._admit(queue)
            self._prefill_step(params)
            self._decode_step(params)
            self.steps += 1
        return self.results, time.perf_counter() - t0
