"""DecodeEngine, the counterpart of ``storm_tpu/decode/engine.py``: the
KV-cache-backed autoregressive step of char_tiny, in torch on the engine's
device.

One ``predict(rows)`` call is one co-batched step over int ``(B, 3)`` rows
``[slot, token, pos]``:

- decode and prefill rows (``slot >= 0``) write their k and v into the
  leased arena slot at ``pos`` and attend causally over the slot's prefix.
  Within each layer every row's k and v are written before any row
  gathers, so a prompt submitted as T same-slot rows in one batch
  prefills correctly: prefill is a decode step with more rows, and it
  co-batches with single-token steps of other sessions;
- classify rows (``slot == -1``) are the stateless next-char view
  (:func:`storm_tpu_torch.models.chartiny.stateless_logits`): the row
  attends only to itself at position 0 and touches no cache.

The engine is predict-only: the continuous batcher runs it serialized on
its dispatcher thread, which keeps the arena's write-then-gather order
safe (the arena lock still guards the event loop's leases).

Early exit (``early_exit_threshold``): after layer 0, rows whose interim
max-softmax (shared head) clears the threshold keep that hidden state
frozen through the remaining layers, which still write their k and v
from it, so the cache stays complete; their logits are the exit logits.
The exit is computed with masks on the device, so a step reads the card
back once: the logits and the exit flags in one copy. The rows' indices
go to the card in one copy too; lengths, leases and pins stay on the
host. This step runs plain torch ops: storm_tpu's decode calls no Pallas
kernel, and neither does the port's.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from storm_tpu_torch.decode.kvcache import KvCacheManager
from storm_tpu_torch.device import resolve_device
from storm_tpu_torch.models import chartiny as ct
from storm_tpu_torch.models.convert import chartiny_params
from storm_tpu_torch.obs import copyledger as _copyledger
from storm_tpu_torch.obs import profile as _profile_mod

STATELESS = -1  # slot value for classify rows

__all__ = ["DecodeEngine", "shared_decode_engine", "STATELESS"]


class DecodeEngine:
    """Stateful per-step forward over a :class:`KvCacheManager` arena on
    ``device`` (default ``cuda``; pass ``"cpu"`` for the CPU).

    Meets the continuous batcher's predict-only contract (``predict(x) ->
    (B, VOCAB)`` numpy) and the observatory's occupancy row
    (``profile_key``, ``model_cfg.name``, ``ring_inflight``/
    ``ring_capacity``)."""

    def __init__(self, *, seed: int = 0, blocks: int = 32, max_seq: int = ct.MAX_SEQ,
                 early_exit_threshold: Optional[float] = None,
                 engine_key: str = "char_tiny@decode", device=None) -> None:
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.params = chartiny_params(ct.build_params(seed), self.device)
        self.kv = KvCacheManager(blocks, ct.N_LAYERS, max_seq, ct.D_MODEL,
                                 engine_key=engine_key, device=self.device)
        self.early_exit_threshold = early_exit_threshold
        self.profile_key = engine_key
        # Queue identity and observatory naming: the classify view of the
        # same weights is also "char_tiny".
        self.model_cfg = SimpleNamespace(name="char_tiny")
        self.ring_capacity = 1  # serialized predict-only engine
        self.ring_inflight = 0
        self._profile = _profile_mod.profile_store()
        self.steps = 0
        self.rows_decode = 0
        self.rows_classify = 0
        self.early_exits = 0
        self._lock = threading.Lock()  # counters only; predict is serialized

    # ---- the step ------------------------------------------------------------

    def predict(self, x) -> np.ndarray:
        """One co-batched step: ``x`` int (B, 3) rows [slot, token, pos]
        -> (B, VOCAB) float32 next-token logits."""
        t0 = time.perf_counter()
        rows = np.asarray(x)
        if rows.ndim != 2 or rows.shape[1] != 3:
            raise ValueError(f"decode rows must be (B, 3) [slot, token, pos], got {rows.shape}")
        rows = rows.astype(np.int64, copy=False)
        slots, tokens, poss = rows[:, 0], rows[:, 1], rows[:, 2]
        b = len(rows)
        cached = slots >= 0
        if np.any(poss[cached] >= self.kv.max_seq):
            raise ValueError(f"position {int(poss[cached].max())} exceeds kv arena "
                             f"max_seq {self.kv.max_seq}")
        n_dec = int(cached.sum())
        # Widest prefix any row of this batch needs.
        t_max = int(poss[cached].max()) + 1 if n_dec else 1

        # One copy to the card: per row [slot (0 for classify), token,
        # position (0 for classify), cached], then the cached rows' indices.
        head = np.stack([np.where(cached, slots, 0), tokens, np.where(cached, poss, 0),
                         cached.astype(np.int64)], axis=1)
        host = np.concatenate([head.reshape(-1), np.nonzero(cached)[0]])
        dev = torch.from_numpy(host).to(self.device)
        cols = dev[:4 * b].view(b, 4)
        slot_t, tok_t, pos_t = cols[:, 0], cols[:, 1], cols[:, 2]
        cached_t = cols[:, 3].bool()
        cidx = dev[4 * b:]
        slot_c, pos_c = slot_t[cidx], pos_t[cidx]

        params = self.params
        h = params["embed"][tok_t] + params["pos"][pos_t]
        jj = torch.arange(t_max, device=self.device)
        # Cached rows see j <= pos_i of their slot; classify rows only j == 0.
        mask = torch.where(cached_t[:, None], jj[None, :] <= pos_t[:, None], jj[None, :] == 0)
        exited = torch.zeros(b, dtype=torch.bool, device=self.device)
        exit_logits = None
        arena = self.kv.arena
        for layer in range(ct.N_LAYERS):
            # q, k, v for every row: exited rows keep writing k and v from
            # their frozen hidden so their cache prefix stays complete.
            q, k, v = ct.qkv(params, layer, h)
            # ---- write phase: every cached row lands in the arena first ----
            if n_dec:
                arena[slot_c, layer, 0, pos_c] = k[cidx]
                arena[slot_c, layer, 1, pos_c] = v[cidx]
            # ---- gather and attend -----------------------------------------
            keys = arena[slot_t, layer, 0, :t_max]
            vals = arena[slot_t, layer, 1, :t_max]
            if n_dec < b:
                # A classify row attends to its own k and v (position 0;
                # the mask hides every other position).
                keys = torch.where(cached_t[:, None, None], keys, k[:, None, :])
                vals = torch.where(cached_t[:, None, None], vals, v[:, None, :])
            h_new = ct.mlp_out(params, layer, ct.attn_out(params, layer, h, q, keys, vals, mask))
            h = torch.where(exited[:, None], h, h_new)
            if layer == 0 and self.early_exit_threshold is not None:
                lg = ct.logits_head(params, h)
                p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
                # The exit is decided once, after layer 0: no row has
                # exited before it.
                exited = p.amax(dim=-1) / p.sum(dim=-1) >= self.early_exit_threshold
                exit_logits = lg

        logits = ct.logits_head(params, h)
        if exit_logits is not None:
            logits = torch.where(exited[:, None], exit_logits, logits)
        # The step's one read back: logits and exit flags together.
        out = torch.cat([logits, exited[:, None].to(logits.dtype)], dim=1).cpu().numpy()
        n_exit = int(out[:, ct.VOCAB].sum())

        # Advance per-slot lengths to the furthest position written.
        if n_dec:
            for s in np.unique(slots[cached]):
                self.kv.advance(int(s), int(poss[slots == s].max()) + 1)

        ms = (time.perf_counter() - t0) * 1e3
        with self._lock:
            self.steps += 1
            self.rows_decode += n_dec
            self.rows_classify += b - n_dec
            self.early_exits += n_exit
        if _profile_mod.enabled():
            self._profile.record_batch(self.profile_key, b, b, {"compute_ms": ms})
        if n_dec and _copyledger.active():
            # One k and one v row per layer per cached input land in the arena.
            _copyledger.record("kv_append", n_dec * ct.N_LAYERS * 2 * ct.D_MODEL * 4,
                               copies=0, allocs=0, records=n_dec, engine=self.profile_key)
        return np.ascontiguousarray(out[:, :ct.VOCAB], dtype=np.float32)

    # ---- convenience ---------------------------------------------------------

    def greedy_step(self, slot: int, token: int, pos: int) -> int:
        """One row's step: the argmax token after ``token`` at ``pos`` in
        ``slot`` (a deterministic oracle for tests and replays)."""
        lg = self.predict(np.array([[slot, token, pos]], np.int64))
        return int(np.argmax(lg[0]))

    def prefill_rows(self, slot: int, tokens, start: int = 0) -> np.ndarray:
        """The (T, 3) row block that prefills ``tokens`` into ``slot`` from
        position ``start``: one submission, one batch."""
        toks = np.asarray(tokens, np.int64).reshape(-1)
        out = np.empty((len(toks), 3), np.int64)
        out[:, 0] = slot
        out[:, 1] = toks
        out[:, 2] = np.arange(start, start + len(toks))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "engine": self.profile_key,
                "steps": self.steps,
                "rows_decode": self.rows_decode,
                "rows_classify": self.rows_classify,
                "early_exits": self.early_exits,
                "kv": self.kv.occupancy(),
            }


# ---- the process-shared engine (one arena per config and device) -------------

_SHARED: Dict[Tuple, DecodeEngine] = {}
_SHARED_LOCK = threading.Lock()


def shared_decode_engine(*, seed: int = 0, blocks: int = 32, max_seq: int = ct.MAX_SEQ,
                         early_exit_threshold: Optional[float] = None,
                         device=None) -> DecodeEngine:
    """Process-cached :class:`DecodeEngine` keyed on its config and device,
    so every decode bolt task of a process shares one arena and one batcher
    queue (the co-batching premise). Registered with the classify engine
    cache's auxiliary list, so the observatory's occupancy rows see it."""
    dev = resolve_device(device)
    key = (int(seed), int(blocks), int(max_seq), early_exit_threshold, str(dev))
    with _SHARED_LOCK:
        eng = _SHARED.get(key)
        if eng is None:
            eng = DecodeEngine(seed=seed, blocks=blocks, max_seq=max_seq,
                               early_exit_threshold=early_exit_threshold, device=dev)
            _SHARED[key] = eng
            from storm_tpu_torch.infer.engine import register_aux_engine

            register_aux_engine(eng)
        return eng


def _reset_engines() -> None:
    """Drop the shared-engine cache (tests; arenas die with it)."""
    with _SHARED_LOCK:
        _SHARED.clear()
