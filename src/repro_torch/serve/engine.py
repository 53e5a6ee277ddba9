"""Serving engines: the static step-locked batch and continuous batching
over a block-paged KV cache.  Both share ``ServeConfig``.

``Engine``, the static engine: one prefill of the whole prompt batch
(models/model.forward with its cache), then every row decodes in
lockstep against a contiguous cache (``decode_step``) until
``max_new_tokens``; a finished row keeps decoding into its own slots and
is masked to eos.  A vlm's patches (``generate``'s ``extra_inputs``)
prefill ahead of the prompt, so decode positions start at the prefill's
length, patches included; the audio family's frames feed the encoder
and never sit ahead of the prompt, so its decode positions count from
the prompt's length.  The cache holds K / V by position (under a
sliding window a ring: position p at slot p % window), MLA's latent and
k_rope, for the ssm and hybrid families each layer's conv and ssm
state, and for the audio family each decoder layer's cross K / V of the
encoder output, made once at prefill (``Engine._grow_cache``).  Shapes never change, so it is the simplest
pattern, but a batch is as slow as its longest request.  Every sparse FFN
junction runs through kernels/block_sparse_matmul.fwd / gated_fwd (the
int8 kernels under ``quantize="int8"``); attention is the plain
``attention.decode_attention``.  Sampling and the guard stay on the
card: a ``generate`` reads its tokens back once, at its end.

``ContinuousEngine``: requests carry their own prompt, max_new and
arrival tick.  An admission loop refills free slots from the queue
mid-flight, prompts prefill in fixed-size chunks interleaved with decode
ticks, and the KV cache is a block-paged pool
(models/model.make_paged_cache) where refilling a slot swaps a
page-table row and never copies the cache.  Invariants:

* the decode tick always has the shapes (token [B,1], positions [B],
  page_table [B,maxp]) and a prefill chunk always [1, C]: admission,
  refill and completion change only integers;
* page accounting is all-or-nothing at admission (serve/paged.PagePool),
  so there is no mid-flight exhaustion and no preemption;
* pool page 0 is the scratch page: free and still-prefilling slots point
  at it during a decode tick, so their writes never touch live pages;
* decode attends through kernels/flash_attention.flash_decode, and every
  sparse FFN junction runs through kernels/block_sparse_matmul.fwd (the
  int8 kernels under ``ServeConfig.quantize="int8"``); the kernels'
  launch counts over a run land in ``stats["launches"]``.

Sampling is greedy (the first maximum) or by temperature from one
``torch.Generator`` seeded with ``ServeConfig.seed`` and advanced once a
sample (the reference's fresh key a sample): deterministic under a seed,
but not the draws of ``jax.random.categorical``.  A row or slot whose
logits go non-finite is terminated (filled with eos, or 0 when eos is
unset) and counted (``nonfinite_terminated``).

With a ``recorder`` (obs.Recorder), every finished request of the
continuous engine emits one ``obs.RequestSpan`` (enqueue -> admit ->
prefill chunks -> first token -> finish, outcome eos | max_new | guard),
TTFT and inter-token latencies land in histograms, and page-pool and
slot gauges refresh every tick.  All of it is host bookkeeping on values
the scheduler already has on the host (the sampled tokens, the guard
flags): the recorder adds no sync and no launch.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import quantize as qz
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M
from repro_torch.obs import telemetry as obs
from repro_torch.serve.paged import PagePool
from repro_torch.train.steps import make_decode_step, make_prefill_step
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_token: int = -1     # -1: never stop early
    seed: int = 0
    # a slot whose logits go non-finite is terminated (filled with eos,
    # or 0 when eos is unset) instead of sampling garbage; others go on
    guard_nonfinite: bool = True
    slots: int = 4          # decode batch width (fixed tick shape)
    page_size: int = 16     # tokens per KV page
    num_pages: int = 0      # pool budget; 0: full residency
                            # (slots * ceil(max_seq/page_size) + scratch)
    prefill_chunk: int = 32 # chunked-prefill width (fixed [1, C] shape)
    max_seq: int = 0        # per-request prompt+new cap; 0: cfg.max_seq
    # quantize at load: "int8" turns every sparse junction's weights into
    # int8 codes and per-block scales (core/quantize.quantize_tree) when
    # the engine takes the params, so every FFN junction runs the int8
    # kernels; dense layers (attention, embeddings) stay as they are.
    # None serves the weights as given.  "fxp" is refused: its table
    # bakes one activation per junction, which fits the paper's MLP
    # (launch/quant_sweep.py), not a transformer's FFN.
    quantize: str | None = None


@dataclasses.dataclass
class Request:
    """One serving request.  ``arrival`` is in scheduler ticks: the
    request becomes admissible once the engine's tick counter reaches it."""
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int
    arrival: int = 0


_FREE, _PREFILL, _DECODE = 0, 1, 2


class _Slot:
    __slots__ = ("state", "req", "pages", "cache_len", "prefill_pos", "out",
                 "last_tok", "t_admit", "t_wall", "t_first", "t_last",
                 "first_tick", "chunks")

    def __init__(self):
        self.state = _FREE
        self.req: Request | None = None
        self.pages: list[int] = []
        self.cache_len = 0        # tokens written to the paged cache
        self.prefill_pos = 0      # prompt tokens prefilled so far
        self.out: list[int] = []
        self.last_tok = 0         # sampled, not yet fed through decode
        self.t_admit = 0
        self.t_wall = 0.0
        # span bookkeeping (obs.RequestSpan): first-token wall time and
        # tick, the previous token's wall time (inter-token latency)
        self.t_first = -1.0
        self.t_last = -1.0
        self.first_tick = -1
        self.chunks = 0


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


def _check_quantize(scfg: ServeConfig) -> None:
    if scfg.quantize not in (None, "int8"):
        raise ValueError(
            f"ServeConfig.quantize={scfg.quantize!r}: serving supports "
            "'int8' only (fxp bakes one table activation per junction; use "
            "launch/quant_sweep.py for it)")


def _load_params(params, scfg: ServeConfig, dev):
    """The params on ``dev``, quantized at load under ``quantize``."""
    params = _to_device(params, dev)
    if scfg.quantize:
        params = qz.quantize_tree(params, qz.QuantConfig(mode="int8"))
    return params


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    """logits [N, V] fp32 -> tokens [N]: the first maximum, or one draw
    a row from softmax(logits / temperature) advancing ``gen`` once."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


class Engine:
    """The static engine.  ``generate(prompts)`` serves a batch of equal-
    length prompts [B, S] (right-aligned, padded with 0) and returns the
    tokens [B, max_new_tokens].  Runs on the card unless ``device`` names
    another device.  ``_prefill`` and ``_decode`` are the step functions
    of train/steps.py."""

    def __init__(self, cfg: ArchConfig, params,
                 serve_cfg: ServeConfig | None = None, device=None):
        self.device = resolve_device(device)
        self.scfg = serve_cfg or ServeConfig()
        M.cache_seq_axes(cfg)   # raises for a family the cache cannot hold
        _check_quantize(self.scfg)
        self.cfg = cfg
        self.params = _load_params(params, self.scfg, self.device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_decode_step(cfg)
        # rows terminated by the guard in the last generate()
        self.nonfinite_terminated = 0

    def _sample(self, logits, gen):
        return _sample(logits, self.scfg.temperature, gen)

    @staticmethod
    def _guard(logits2d):
        """(bad [B] bool, logits with a bad row zeroed): a row with any
        non-finite logit is flagged and sampling stays defined."""
        bad = ~torch.isfinite(logits2d).all(dim=-1)
        return bad, torch.where(bad[:, None], 0.0, logits2d)

    def generate(self, prompts: np.ndarray,
                 extra_inputs: dict | None = None) -> np.ndarray:
        """prompts [B, S] int (and ``extra_inputs``: for the vlm
        {"patches": [B, P, d]}, for the audio family {"frames": [B, F,
        d]}) -> tokens [B, max_new_tokens] int32."""
        self.nonfinite_terminated = 0   # before any branch: never stale
        scfg, dev = self.scfg, self.device
        B = prompts.shape[0]
        batch = {"tokens": torch.from_numpy(
            np.asarray(prompts, np.int32)).to(dev)}
        for k, v in (extra_inputs or {}).items():
            batch[k] = torch.as_tensor(np.asarray(v), device=dev)
        # S: the prefill's positions, side inputs ahead of the prompt
        logits, cache, S = self._prefill(self.params, batch)
        cache = self._grow_cache(cache, B, S + scfg.max_new_tokens, S)
        gen = torch.Generator(device=dev)
        gen.manual_seed(scfg.seed)
        guard, eos = scfg.guard_nonfinite, scfg.eos_token
        # a terminated row is filled with eos, or 0 when eos is unset
        fill = eos if eos >= 0 else 0
        nf = torch.zeros((B,), dtype=torch.bool, device=dev)
        step_logits = logits[:, -1].float()
        if guard:
            bad, step_logits = self._guard(step_logits)
            nf = nf | bad
        tok = self._sample(step_logits, gen)[:, None]
        if guard:
            tok = torch.where(nf[:, None], fill, tok)
        out = [tok]
        done = nf.clone()
        for i in range(scfg.max_new_tokens - 1):
            logits, cache = self._decode(self.params, cache, tok, S + i)
            step_logits = logits[:, -1].float()
            if guard:
                bad, step_logits = self._guard(step_logits)
                nf = nf | bad
                done = done | bad
            nxt = self._sample(step_logits, gen)[:, None]
            if eos >= 0:
                done = done | (tok[:, 0] == eos)
            if eos >= 0 or guard:
                nxt = torch.where(done[:, None], fill, nxt)
            tok = nxt
            out.append(tok)
        res = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
        if guard:
            self.nonfinite_terminated = int(nf.sum())
        return res

    def _grow_cache(self, cache, B: int, total: int, S: int):
        """The prefill cache (sequence S) copied into a static cache of
        ``total`` positions, by ``M.cache_seq_axes``: a sequence leaf at
        position 0 of its sequence axis, zeros beyond; a sliding window's
        ring (W < S slots) keeps the last W positions, position p at slot
        p % W, where decode reads and writes it; a state leaf (axis -1:
        conv and ssm states, the cross K / V) whole."""
        full = M.make_cache(self.cfg, B, total, self.device)

        def place(ax, dst, src):
            if ax < 0:
                if dst.shape != src.shape:
                    raise ValueError(f"state leaf {tuple(src.shape)} does "
                                     f"not fit {tuple(dst.shape)}")
                return dst.copy_(src)
            W = dst.shape[ax]
            if S <= W:
                dst.narrow(ax, 0, S).copy_(src)
            else:
                dst.copy_(torch.roll(src.narrow(ax, S - W, W), (S - W) % W,
                                     ax))
            return dst

        return tree_map(place, M.cache_seq_axes(self.cfg), full, cache)


class ContinuousEngine:
    """``serve(requests)`` drives admission, chunked prefill and decode
    until every request completes and returns {rid: generated tokens}.
    ``stats`` then holds tick counts, per-request latencies, page
    accounting and the kernels' launch counts over the run.  Runs on the
    card unless ``device`` names another device.  ``recorder`` gets the
    spans, histograms and gauges of the module docstring."""

    def __init__(self, cfg: ArchConfig, params,
                 serve_cfg: ServeConfig | None = None, device=None,
                 recorder: "obs.Recorder | None" = None):
        self.device = resolve_device(device)
        self.rec = recorder
        self.scfg = serve_cfg or ServeConfig()
        ok, why = M.paged_supported(cfg)
        if not ok:
            raise ValueError(f"ContinuousEngine: {why}")
        _check_quantize(self.scfg)
        self.cfg = cfg
        self.params = _load_params(params, self.scfg, self.device)
        self.max_seq = self.scfg.max_seq or cfg.max_seq
        self.pages_per_slot = -(-self.max_seq // self.scfg.page_size)
        self.nonfinite_terminated = 0
        self.stats: dict = {}

    def _sample(self, logits, gen):
        return _sample(logits, self.scfg.temperature, gen)

    def _tick(self, pool, tokens, positions, page_table, gen):
        logits, pool = M.paged_decode_step(self.cfg, self.params, pool,
                                           tokens, positions, page_table)
        lg = logits[:, -1].float()
        bad = ~torch.isfinite(lg).all(dim=-1)
        lg = torch.where(bad[:, None], 0.0, lg)
        return self._sample(lg, gen), bad

    # ---------------------------------------------------------- scheduler
    def serve(self, requests: list[Request]) -> dict[int, np.ndarray]:
        scfg, dev = self.scfg, self.device
        B, ps = scfg.slots, scfg.page_size
        maxp = self.pages_per_slot
        num_pages = scfg.num_pages or (B * maxp + 1)
        for r in requests:
            prompt = np.asarray(r.prompt)
            if prompt.ndim != 1 or len(prompt) == 0:
                raise ValueError(f"request {r.rid}: prompt must be a "
                                 "non-empty 1-D token array")
            if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
                raise ValueError(f"request {r.rid}: token ids must lie in "
                                 f"[0, {self.cfg.vocab})")
            need = len(r.prompt) + r.max_new_tokens
            if need > self.max_seq:
                raise ValueError(
                    f"request {r.rid}: prompt+max_new = {need} exceeds "
                    f"max_seq {self.max_seq}")
            if -(-need // ps) > num_pages - 1:
                raise ValueError(
                    f"request {r.rid} needs more pages than the pool holds")
        pool_acct = PagePool(num_pages, ps)
        pool = M.make_paged_cache(self.cfg, num_pages, ps, dev)
        slots = [_Slot() for _ in range(B)]
        # FIFO within arrival order (stable sort keeps submission order)
        queue = collections.deque(sorted(requests, key=lambda r: r.arrival))
        gen = torch.Generator(device=dev)
        gen.manual_seed(scfg.seed)
        self.nonfinite_terminated = 0
        eos = scfg.eos_token
        guard = scfg.guard_nonfinite
        outputs: dict[int, np.ndarray] = {}
        lat: dict[int, dict] = {}
        tick = 0
        decode_ticks = prefill_chunks = 0
        pf_cursor = 0               # round-robin over prefilling slots
        launches0 = ops.launch_counts()
        t_serve0 = time.perf_counter()
        rec = self.rec

        def finish(s: _Slot, outcome: str):
            r = s.req
            outputs[r.rid] = np.asarray(s.out, np.int32)
            ttft = s.t_first - s.t_wall if s.t_first >= 0 else -1.0
            lat[r.rid] = {"arrival": r.arrival, "admitted": s.t_admit,
                          "finished": tick, "outcome": outcome,
                          "ttft_s": ttft, "first_token_tick": s.first_tick,
                          "prefill_chunks": s.chunks,
                          "n_tokens": len(s.out),
                          "wall_s": time.perf_counter() - s.t_wall}
            if rec is not None:
                rec.count(f"serve.finish.{outcome}")
                if ttft >= 0:
                    rec.observe("serve.ttft_s", ttft)
                rec.emit(obs.RequestSpan(
                    rid=r.rid, outcome=outcome, enqueue_tick=r.arrival,
                    admit_tick=s.t_admit, first_token_tick=s.first_tick,
                    finish_tick=tick, prefill_chunks=s.chunks,
                    n_tokens=len(s.out), ttft_s=ttft,
                    wall_s=lat[r.rid]["wall_s"]))
            pool_acct.release(s.pages)
            s.__init__()            # back to FREE

        def step_done(s: _Slot, tok: int) -> str | None:
            """Record one sampled token; the outcome ("eos" | "max_new")
            when the request completed, else None."""
            now = time.perf_counter()
            if not s.out:           # the request's first token
                s.t_first = now
                s.first_tick = tick
            elif rec is not None and s.t_last >= 0:
                rec.observe("serve.itl_s", now - s.t_last)
            s.t_last = now
            s.out.append(tok)
            s.last_tok = tok
            if eos >= 0 and tok == eos:
                return "eos"
            return "max_new" if len(s.out) >= s.req.max_new_tokens else None

        while queue or any(s.state != _FREE for s in slots):
            # ---- admission: refill free slots from the arrival queue
            for s in slots:
                if s.state != _FREE or not queue:
                    continue
                if queue[0].arrival > tick:
                    break
                need = pool_acct.pages_for(
                    len(queue[0].prompt) + queue[0].max_new_tokens)
                pages = pool_acct.alloc(need)
                if pages is None:
                    break           # pool full: stays queued, retry next tick
                r = queue.popleft()
                s.state = _PREFILL
                s.req = r
                s.pages = pages
                s.t_admit = tick
                s.t_wall = time.perf_counter()

            # ---- one prefill chunk (round-robin), interleaved with decode
            pf_slots = [i for i, s in enumerate(slots) if s.state == _PREFILL]
            if pf_slots:
                s = slots[pf_slots[pf_cursor % len(pf_slots)]]
                pf_cursor += 1
                prompt = s.req.prompt
                C = scfg.prefill_chunk
                cl = min(C, len(prompt) - s.prefill_pos)
                buf = np.zeros((1, C), np.int32)
                buf[0, :cl] = prompt[s.prefill_pos:s.prefill_pos + cl]
                logits, pool = M.paged_prefill_chunk(
                    self.cfg, self.params, pool,
                    torch.from_numpy(buf).to(dev), s.prefill_pos,
                    torch.from_numpy(self._page_row(s, maxp)).to(dev), cl)
                prefill_chunks += 1
                s.chunks += 1
                s.prefill_pos += cl
                s.cache_len = s.prefill_pos
                if s.prefill_pos == len(prompt):
                    row = logits[:, -1].float()
                    bad = not bool(torch.isfinite(row).all())
                    if guard and bad:
                        self.nonfinite_terminated += 1
                        s.out.append(eos if eos >= 0 else 0)
                        finish(s, "guard")
                    else:
                        oc = step_done(s, int(self._sample(row, gen)[0]))
                        if oc:
                            finish(s, oc)
                        else:
                            s.state = _DECODE

            # ---- decode tick: ONE fixed-shape call for the whole batch
            dec = [i for i, s in enumerate(slots) if s.state == _DECODE]
            if dec:
                tokens = np.zeros((B, 1), np.int32)
                positions = np.zeros((B,), np.int32)
                pt = np.zeros((B, maxp), np.int32)   # scratch page default
                for i in dec:
                    s = slots[i]
                    tokens[i, 0] = s.last_tok
                    positions[i] = s.cache_len
                    pt[i] = self._page_row(s, maxp)
                tok, bad = self._tick(
                    pool, torch.from_numpy(tokens).to(dev),
                    torch.from_numpy(positions).to(dev),
                    torch.from_numpy(pt).to(dev), gen)
                decode_ticks += 1
                tok, bad = tok.cpu().numpy(), bad.cpu().numpy()
                for i in dec:
                    s = slots[i]
                    s.cache_len += 1
                    if guard and bad[i]:
                        self.nonfinite_terminated += 1
                        s.out.append(eos if eos >= 0 else 0)
                        finish(s, "guard")
                    else:
                        oc = step_done(s, int(tok[i]))
                        if oc:
                            finish(s, oc)
            elif not pf_slots and queue:
                # idle: jump the clock to the next arrival
                tick = max(tick, queue[0].arrival - 1)
            if rec is not None:
                # occupancy gauges every tick, off the host's accounting
                rec.gauge("serve.pages_in_use", pool_acct.in_use)
                rec.gauge("serve.pages_free", pool_acct.free_pages)
                states = [s.state for s in slots]
                rec.gauge("serve.slots_decode", states.count(_DECODE))
                rec.gauge("serve.slots_prefill", states.count(_PREFILL))
                rec.gauge("serve.slots_free", states.count(_FREE))
                rec.count("serve.ticks")
            tick += 1

        launches = ops.launch_counts()
        self.stats = {
            "ticks": tick, "decode_ticks": decode_ticks,
            "prefill_chunks": prefill_chunks,
            "peak_pages": pool_acct.peak_in_use,
            "num_pages": num_pages, "page_size": ps,
            "wall_s": time.perf_counter() - t_serve0,
            "latency": lat,
            "launches": {k: launches[k] - launches0[k] for k in launches},
        }
        return outputs

    @staticmethod
    def _page_row(s: _Slot, maxp: int) -> np.ndarray:
        row = np.zeros((maxp,), np.int32)       # sentinel: scratch page 0
        row[:len(s.pages)] = s.pages
        return row
