"""Token-level (continuous-batching) generation scheduler over a paged
KV cache, on one card.

Port of ``dlrover_tpu/rl/scheduler.py`` (``GenRequest``, ``GenResult``,
``SchedulerConfig`` :105-202 and ``ContinuousBatchingScheduler``
:204-1706) without the parts that ride on other planes: fleet lanes and
prefill shipping, the separate drafter, logprob capture, event spans
and ``compile_counts`` (PyTorch runs eagerly; there is nothing to
compile).

- The batch is ``max_slots`` fixed lanes, each holding (or not) one live
  sequence: an active mask, never a shape change.  Every step runs the
  same shapes, so each lane's row is computed the same way whatever the
  other lanes hold.
- Prompts prefill in fixed-size chunks, one chunk per iteration
  (round-robin), interleaved with the running decodes.
- A sequence leaves its lane at EOS or at its token budget, and the
  freed lane admits the next queued prompt in the same iteration.

Allocation (``DLROVER_TPU_KV_INCREMENTAL``, default on): incremental
admission reserves the prompt's blocks plus ``DLROVER_TPU_KV_GROW_BLOCKS``
headroom behind a free-pool watermark (``DLROVER_TPU_KV_ADMIT_WATERMARK``),
tables grow on demand, and when the pool runs dry the lowest-priority
lane is preempted and requeued at the head with its generated tail, to
re-prefill and resume.  Full prompt blocks are shared through the
pool's content-hashed index (``DLROVER_TPU_KV_PREFIX_CACHE``).  ``=0``
reserves the worst case at admission instead.

Multi-token decode (``DLROVER_TPU_DECODE_STEPS=K``, default 1): K greedy
self-drafting decode steps, then ONE verify forward
(``models.llama.paged_verify_step``) scores the window, and the longest
agreeing draft prefix is accepted.  At temperature 0 the emitted stream
is exactly the K=1 stream (each draft step IS the K=1 computation); at
temperature > 0 acceptance is rejection-style.

Determinism: tokens are sampled as a pure function of (seed, position)
(``rl/sampling.py``), so a request's tail does not depend on its lane,
its batch, or a preemption.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.env import (
    decode_steps,
    kv_admit_watermark,
    kv_grow_blocks,
    kv_incremental_enabled,
    kv_prefix_cache_enabled,
)
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.rl.kv_cache import (
    BlockPool,
    OutOfBlocksError,
    PagedCacheConfig,
    init_block_pool,
    pool_can_ever_hold,
    prefix_block_keys,
)
from dlrover_tpu_torch.rl.sampling import sample_tokens

FINISH_EOS = "eos"
FINISH_LENGTH = "length"


def _empty_tokens() -> np.ndarray:
    return np.zeros((0,), np.int32)


@dataclass
class GenRequest:
    """One generation request (prompt in, sampled tail out).
    ``resume_tokens`` carries a preempted sequence's generated tail: on
    re-admission the scheduler re-prefills prompt+tail and resumes at
    the next position."""

    req_id: int
    prompt: np.ndarray  # [P] int32
    max_new: int
    seed: int = 0
    submit_t: float = field(default_factory=time.monotonic)
    resume_tokens: np.ndarray = field(default_factory=_empty_tokens)
    preempts: int = 0
    hit_blocks: int = 0


@dataclass
class GenResult:
    req_id: int
    tokens: np.ndarray  # [P + new] int32 (prompt verbatim + tail)
    finish_reason: str
    new_tokens: int
    latency_s: float
    stats: Dict = field(default_factory=dict)


@dataclass(frozen=True)
class SchedulerConfig:
    """Serving geometry: every field fixes a shape of the device
    inputs; traffic never changes one."""

    max_slots: int = 8  # decode lanes
    block_size: int = 16  # tokens per KV block
    num_blocks: int = 256  # pool size incl. the null block
    max_seq_len: int = 512  # longest prompt+tail a slot may hold
    prefill_chunk: int = 32  # prompt tokens prefilled per iteration
    max_new_default: int = 64
    temperature: float = 1.0
    eos_id: Optional[int] = None

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_seq_len // self.block_size)


@dataclass
class _Slot:
    req: Optional[GenRequest] = None
    phase: str = "free"  # free | prefill | decode
    prefill_pos: int = 0
    prefill_tokens: np.ndarray = field(default_factory=_empty_tokens)
    prefill_len: int = 0  # prompt + resume-tail tokens to prefill
    prefix_keys: List[str] = field(default_factory=list)
    shared_upto: int = 0  # prompt blocks registered in the index
    admit_seq: int = 0  # monotonic admission order (victim policy)
    generated: List[int] = field(default_factory=list)
    first_token_t: float = 0.0


class ContinuousBatchingScheduler:
    """The token-level serving loop over a paged KV cache.

    ``device`` defaults to ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain path.  The pool lives on ``device``;
    params handed to :meth:`sync_weights` must live there too."""

    def __init__(
        self,
        model_cfg: llama.LlamaConfig,
        sched: Optional[SchedulerConfig] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.sched = sched or SchedulerConfig()
        s = self.sched
        if s.prefill_chunk < 1 or s.max_slots < 1:
            raise ValueError("prefill_chunk and max_slots must be >= 1")
        self._params = None

        # allocation/decode discipline, pinned at construction
        self.incremental = kv_incremental_enabled()
        self.grow_blocks = kv_grow_blocks()
        self.admit_watermark = kv_admit_watermark()
        self.prefix_cache = self.incremental and kv_prefix_cache_enabled()
        self.decode_k = decode_steps()

        self.pool_cfg = PagedCacheConfig(
            n_layers=model_cfg.n_layers,
            n_kv_heads=model_cfg.n_kv_heads,
            head_dim=model_cfg.head_dim,
            num_blocks=s.num_blocks,
            block_size=s.block_size,
            dtype=model_cfg.dtype,
        )
        self.block_pool = BlockPool(self.pool_cfg)
        self._pool = init_block_pool(self.pool_cfg, self.device)

        # host mirrors of the fixed-shape device inputs
        S, MB = s.max_slots, s.max_blocks_per_seq
        self._tables = np.zeros((S, MB), np.int32)
        self._positions = np.zeros((S,), np.int32)
        self._active = np.zeros((S,), bool)
        self._next_token = np.zeros((S,), np.int32)
        self._seeds = np.zeros((S,), np.int64)
        self._slots = [_Slot() for _ in range(S)]
        self._queue: List[GenRequest] = []
        # full-prompt block keys memoized per req_id (admission probes
        # the blocked queue head every iteration)
        self._prompt_keys: Dict[int, List[str]] = {}
        self._next_req_id = 0
        self._prefill_rr = 0  # round-robin pointer over prefill slots
        self._admit_counter = 0

        # counters the stats read
        self.total_new_tokens = 0
        self.total_prefill_tokens = 0
        self.iterations = 0
        self.preemptions = 0
        self.grown_blocks = 0
        self.dispatches = 0  # model forwards launched (host cost)
        self.accepted_tokens = 0  # multi-token decode: tokens kept
        self.lane_windows = 0  # multi-token decode: (lane, window)s

    # ------------------------------------------------------------- API
    def sync_weights(self, params):
        """Adopt the current params (reference swap; in-flight
        sequences continue on the new weights)."""
        self._params = params

    def submit(
        self,
        prompt,
        max_new: Optional[int] = None,
        seed: int = 0,
        req_id: Optional[int] = None,
        resume_tokens: Optional[np.ndarray] = None,
    ) -> int:
        """Queue one prompt; returns the request id results carry.
        ``resume_tokens`` re-admits a partially generated sequence: the
        scheduler re-prefills prompt+tail and resumes at the next
        position."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("prompt must hold at least one token")
        max_new = int(
            self.sched.max_new_default if max_new is None else max_new
        )
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if prompt.size + max_new > self.sched.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new} exceeds "
                f"max_seq_len {self.sched.max_seq_len}"
            )
        if self.incremental and not pool_can_ever_hold(
            self.pool_cfg.num_blocks,
            self.pool_cfg.block_size,
            prompt.size + max_new,
        ):
            raise ValueError(
                f"prompt {prompt.size} + max_new {max_new} needs "
                f"{self.pool_cfg.blocks_for(prompt.size + max_new)} "
                f"blocks > pool of {self.pool_cfg.usable_blocks}"
            )
        if req_id is None:
            req_id = self._next_req_id
        self._next_req_id = max(self._next_req_id, req_id) + 1
        resume = (
            np.asarray(resume_tokens, np.int32).reshape(-1)
            if resume_tokens is not None else _empty_tokens()
        )
        if resume.size >= max_new:
            raise ValueError(
                f"resume tail of {resume.size} token(s) already "
                f"meets max_new {max_new} — nothing left to generate"
            )
        self._queue.append(
            GenRequest(req_id=req_id, prompt=prompt, max_new=max_new,
                       seed=int(seed), resume_tokens=resume)
        )
        return req_id

    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def active_count(self) -> int:
        return sum(1 for sl in self._slots if sl.req is not None)

    @property
    def idle(self) -> bool:
        return not self._queue and self.active_count == 0

    def stats(self) -> Dict:
        st = dict(self.block_pool.stats())
        st.update(
            device=str(self.device),
            queue_depth=self.queue_depth,
            active=self.active_count,
            iterations=self.iterations,
            total_new_tokens=self.total_new_tokens,
            total_prefill_tokens=self.total_prefill_tokens,
            preemptions=self.preemptions,
            grown_blocks=self.grown_blocks,
            dispatches=self.dispatches,
            decode_steps=self.decode_k,
            incremental=int(self.incremental),
            accepted_tokens=self.accepted_tokens,
            lane_windows=self.lane_windows,
            accepted_per_step=round(
                self.accepted_tokens / max(self.lane_windows, 1), 4
            ),
        )
        return st

    # ------------------------------------------------------ scheduling
    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _full_prompt_keys(self, req: GenRequest) -> List[str]:
        """Content keys for every FULL block of the request's original
        prompt (computed once per req_id)."""
        keys = self._prompt_keys.get(req.req_id)
        if keys is None:
            bs = self.sched.block_size
            keys = prefix_block_keys(
                req.prompt[: (int(req.prompt.size) // bs) * bs], bs
            )
            self._prompt_keys[req.req_id] = keys
        return keys

    def _admissible(self, req: GenRequest):
        """Decide admission and size the initial allocation: ``None``
        (keep queued, FIFO head-of-line) or the admission plan."""
        cfgp = self.pool_cfg
        bs = cfgp.block_size
        prefill_tokens = (
            np.concatenate([req.prompt, req.resume_tokens])
            if req.resume_tokens.size else req.prompt
        )
        plen = int(prefill_tokens.size)
        total = int(req.prompt.size) + int(req.max_new)
        if not self.incremental:
            # reservation admission: the worst case must fit
            if not self.block_pool.can_allocate(total):
                return None
            return {
                "prefill_tokens": prefill_tokens,
                "n_tokens": total,
                "extra": 0,
                "keys": [],
            }
        keys: List[str] = []
        peek = peek_lru = 0
        if self.prefix_cache:
            # only blocks fully inside the ORIGINAL prompt are shared,
            # and at least one token must remain to prefill (its logits
            # seed the first sampled token)
            max_hit = min((plen - 1) // bs, int(req.prompt.size) // bs)
            if max_hit > 0:
                keys = self._full_prompt_keys(req)[:max_hit]
                peek, peek_lru = self.block_pool.peek_prefix(keys)
        headroom = min(
            self.grow_blocks,
            max(cfgp.blocks_for(total) - cfgp.blocks_for(plen), 0),
        )
        need = cfgp.blocks_for(plen) - peek + headroom
        watermark_blocks = int(
            np.ceil(self.admit_watermark * cfgp.usable_blocks)
        )
        # hits parked in the LRU are consumed by the acquire: they
        # must not double-count as evictable capacity
        avail = self.block_pool.available_blocks - peek_lru
        if self.block_pool.live_sequences > 0 and (
            avail - need < watermark_blocks
        ):
            return None  # watermark: keep headroom for running lanes
        if avail < need:
            return None
        return {
            "prefill_tokens": prefill_tokens,
            "n_tokens": plen,
            "extra": headroom,
            "keys": keys,
        }

    def _admit(self):
        s = self.sched
        while self._queue:
            free = [
                i for i, sl in enumerate(self._slots) if sl.req is None
            ]
            if not free:
                return
            req = self._queue[0]
            plan = self._admissible(req)
            if plan is None:
                return  # head-of-line: later requests must not starve it
            self._queue.pop(0)
            slot = free[0]
            hit_ids = (
                self.block_pool.acquire_prefix(plan["keys"])
                if plan["keys"] else []
            )
            self.block_pool.allocate(
                req.req_id,
                plan["n_tokens"],
                extra_blocks=plan["extra"],
                prefix_blocks=hit_ids,
            )
            self._tables[slot] = self.block_pool.table_row(
                req.req_id, s.max_blocks_per_seq
            )
            self._positions[slot] = 0
            self._active[slot] = False  # decoding starts post-prefill
            self._seeds[slot] = req.seed
            n_hit = len(hit_ids)
            self._admit_counter += 1
            sl = _Slot(
                req=req,
                phase="prefill",
                prefill_tokens=plan["prefill_tokens"],
                prefill_len=int(plan["prefill_tokens"].size),
                prefix_keys=(
                    self._full_prompt_keys(req)
                    if self.prefix_cache else []
                ),
                shared_upto=n_hit,
                admit_seq=self._admit_counter,
            )
            # cached prefix blocks are already filled: prefill starts
            # past them
            sl.prefill_pos = n_hit * s.block_size
            sl.generated = [int(t) for t in req.resume_tokens]
            self._slots[slot] = sl
            self.block_pool.note_filled(req.req_id, sl.prefill_pos)
            req.hit_blocks += n_hit

    def _release_slot(self, slot: int):
        # zero the table row: a freed block re-issued to another
        # sequence must never be read through this lane again
        self._tables[slot] = 0
        self._positions[slot] = 0
        self._active[slot] = False
        self._slots[slot] = _Slot()

    def _finish(self, slot: int, reason: str, finished: List[GenResult]):
        sl = self._slots[slot]
        req = sl.req
        now = time.monotonic()
        finished.append(
            GenResult(
                req_id=req.req_id,
                tokens=np.concatenate(
                    [req.prompt, np.asarray(sl.generated, np.int32)]
                ),
                finish_reason=reason,
                new_tokens=len(sl.generated),
                latency_s=now - req.submit_t,
                stats={
                    "ttft_s": round(
                        max(sl.first_token_t - req.submit_t, 0.0), 6
                    ),
                    "preempts": req.preempts,
                    "prefix_hit_blocks": req.hit_blocks,
                },
            )
        )
        self.block_pool.free(req.req_id)
        self._prompt_keys.pop(req.req_id, None)
        self._release_slot(slot)

    def _preempt(self, slot: int):
        """Evict the sequence in ``slot`` (pool pressure): free its
        blocks and requeue it AT THE HEAD with its generated tail."""
        sl = self._slots[slot]
        req = sl.req
        self.block_pool.free(req.req_id)
        self._queue.insert(
            0,
            GenRequest(
                req_id=req.req_id,
                prompt=req.prompt,
                max_new=req.max_new,
                seed=req.seed,
                submit_t=req.submit_t,
                resume_tokens=np.asarray(sl.generated, np.int32),
                preempts=req.preempts + 1,
                hit_blocks=req.hit_blocks,
            ),
        )
        self._release_slot(slot)
        self.preemptions += 1

    def _pick_victim(self, exclude: int) -> Optional[int]:
        """Lowest-priority live sequence: fewest tokens generated, tie
        broken youngest-admission-first."""
        candidates = [
            i for i, sl in enumerate(self._slots)
            if sl.req is not None and i != exclude
        ]
        if not candidates:
            return None
        return min(
            candidates,
            key=lambda i: (
                len(self._slots[i].generated),
                -self._slots[i].admit_seq,
            ),
        )

    def _ensure_blocks(self):
        """Incremental mode: before a decode window every decoding lane
        must own blocks covering its next K write positions — grow on
        demand, preempt the lowest-priority lane when the pool (free +
        evictable shared) runs dry.  Oldest lanes grow first."""
        if not self.incremental:
            return
        cfgp = self.pool_cfg
        order = sorted(
            (i for i, sl in enumerate(self._slots) if sl.phase == "decode"),
            key=lambda i: self._slots[i].admit_seq,
        )
        for slot in order:
            sl = self._slots[slot]
            if sl.req is None:
                continue  # preempted while an older lane grew
            req = sl.req
            total = int(req.prompt.size) + int(req.max_new)
            need_tokens = min(
                int(self._positions[slot]) + self.decode_k, total
            )
            while self.block_pool.covered_tokens(req.req_id) < need_tokens:
                owned = len(self.block_pool.blocks_of(req.req_id))
                short = cfgp.blocks_for(need_tokens) - owned
                want = min(
                    max(short, self.grow_blocks),
                    cfgp.blocks_for(total) - owned,
                )
                try:
                    self.block_pool.extend(req.req_id, want)
                    self.grown_blocks += want
                except OutOfBlocksError:
                    victim = self._pick_victim(exclude=slot)
                    if victim is None:
                        raise OutOfBlocksError(
                            f"seq {req.req_id} cannot grow and no "
                            "victim remains — pool smaller than one "
                            "sequence's worst case"
                        ) from None
                    self._preempt(victim)
            self._tables[slot] = self.block_pool.table_row(
                req.req_id, self.sched.max_blocks_per_seq
            )

    def _append_token(self, slot: int, token: int,
                      finished: List[GenResult]) -> bool:
        """Append one sampled token; True when the sequence finished
        (EOS / budget) and left its slot."""
        sl = self._slots[slot]
        if not sl.generated:
            sl.first_token_t = time.monotonic()
        sl.generated.append(int(token))
        self.total_new_tokens += 1
        eos = self.sched.eos_id
        if eos is not None and int(token) == int(eos):
            self._finish(slot, FINISH_EOS, finished)
            return True
        if len(sl.generated) >= sl.req.max_new:
            self._finish(slot, FINISH_LENGTH, finished)
            return True
        return False

    def _share_filled_blocks(self, slot: int):
        """Register prompt blocks the prefill has just completed in the
        shared index (full blocks are immutable from here on)."""
        sl = self._slots[slot]
        if not sl.prefix_keys:
            return
        full_now = min(
            sl.prefill_pos // self.sched.block_size, len(sl.prefix_keys)
        )
        for idx in range(sl.shared_upto, full_now):
            self.block_pool.share_block(
                sl.req.req_id, idx, sl.prefix_keys[idx]
            )
        sl.shared_upto = max(sl.shared_upto, full_now)

    @torch.no_grad()
    def _prefill_one(self, finished: List[GenResult]) -> int:
        """Run ONE prompt chunk (round-robin over prefilling slots);
        returns the number of prompt tokens processed."""
        s = self.sched
        slots = [
            i for i, sl in enumerate(self._slots) if sl.phase == "prefill"
        ]
        if not slots:
            return 0
        slot = slots[self._prefill_rr % len(slots)]
        self._prefill_rr += 1
        sl = self._slots[slot]
        req = sl.req
        plen = sl.prefill_len
        start = sl.prefill_pos
        chunk = sl.prefill_tokens[start:start + s.prefill_chunk]
        real = chunk.size
        if real < s.prefill_chunk:
            chunk = np.pad(chunk, (0, s.prefill_chunk - real))
        logits, self._pool = llama.paged_prefill_chunk(
            self._params,
            self._dev(chunk[None].astype(np.int32)),
            self._pool,
            self._dev(self._tables[slot]),
            start,
            self.cfg,
        )
        self.dispatches += 1
        sl.prefill_pos += real
        self.total_prefill_tokens += real
        self.block_pool.note_filled(req.req_id, sl.prefill_pos)
        self._share_filled_blocks(slot)
        if sl.prefill_pos >= plen:
            # the first new token comes from the last REAL prefill
            # position's logits (it lies inside this chunk)
            tok = int(sample_tokens(
                logits[0, plen - 1 - start],
                torch.tensor(req.seed, device=self.device),
                torch.tensor(plen, device=self.device),
                self.sched.temperature,
            ))
            sl.phase = "decode"
            self._positions[slot] = plen
            self._active[slot] = True
            self._next_token[slot] = tok
            self._append_token(slot, tok, finished)
        return real

    def _lane_inputs(self):
        return (
            self._dev(self._next_token),
            self._dev(self._tables),
            self._dev(self._positions),
            self._dev(self._active),
            self._dev(self._seeds),
        )

    @torch.no_grad()
    def _decode_once(self, finished: List[GenResult]) -> int:
        """One decode iteration over every active lane; returns the
        number of tokens sampled."""
        decoding = [
            i for i, sl in enumerate(self._slots) if sl.phase == "decode"
        ]
        if not decoding:
            return 0
        tokens, tables, positions, active, seeds = self._lane_inputs()
        logits, self._pool = llama.paged_decode_step(
            self._params, tokens, self._pool, tables, positions, active,
            self.cfg,
        )
        nxt = sample_tokens(
            logits, seeds, positions.long() + 1, self.sched.temperature
        ).cpu().numpy()
        self.dispatches += 1
        for slot in decoding:
            self._positions[slot] += 1
            self.block_pool.note_filled(
                self._slots[slot].req.req_id, int(self._positions[slot])
            )
            tok = int(nxt[slot])
            if not self._append_token(slot, tok, finished):
                self._next_token[slot] = tok
        return len(decoding)

    @torch.no_grad()
    def _decode_window(self):
        """K greedy self-drafting decode steps plus ONE verify forward.
        Returns (drafts [S, K], verify samples [S, K], leading-match
        count [S]) on the host."""
        K = self.decode_k
        tokens, tables, positions, active, seeds = self._lane_inputs()
        drafts = []
        tok, pos = tokens, positions
        for _ in range(K):
            logits, self._pool = llama.paged_decode_step(
                self._params, tok, self._pool, tables, pos, active, self.cfg
            )
            d = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(d)
            tok, pos = d, pos + 1
        drafts = torch.stack(drafts, dim=1)  # [S, K]
        # verify inputs: the window tokens occupying positions
        # p..p+K-1 (current token + first K-1 drafts), whose K/V the
        # draft loop already wrote
        vin = torch.cat([tokens[:, None], drafts[:, :-1]], dim=1)
        vlogits = llama.paged_verify_step(
            self._params, vin, self._pool, tables, positions, active,
            self.cfg,
        )  # [S, K, V]
        steps = torch.arange(K, device=self.device)
        ver = sample_tokens(
            vlogits, seeds[:, None],
            positions.long()[:, None] + 1 + steps[None],
            self.sched.temperature,
        )
        eq = (ver == drafts).to(torch.int32)
        n_match = torch.cumprod(eq, dim=1).sum(dim=1)
        self.dispatches += 1
        return (drafts.cpu().numpy(), ver.cpu().numpy(),
                n_match.cpu().numpy())

    def _decode_multi_once(self, finished: List[GenResult]) -> int:
        """One K-step decode window; returns the number of tokens
        accepted across lanes."""
        decoding = [
            i for i, sl in enumerate(self._slots) if sl.phase == "decode"
        ]
        if not decoding:
            return 0
        K = self.decode_k
        temp = float(self.sched.temperature)
        drafts, ver, n_match = self._decode_window()
        sampled = 0
        for slot in decoding:
            sl = self._slots[slot]
            remaining = sl.req.max_new - len(sl.generated)
            if temp <= 0:
                # drafts ARE the K=1 greedy stream; the verify pass
                # gates how far the window is trusted, never what is
                # emitted
                acc = max(1, int(n_match[slot]))
                emitted = drafts[slot]
            else:
                # rejection-style: every emitted token is the real-rule
                # sample conditioned on a prefix that matched the drafts
                acc = min(int(n_match[slot]) + 1, K)
                emitted = ver[slot]
            acc = min(acc, remaining, K)
            self.lane_windows += 1
            kept_last = None
            done = False
            for j in range(acc):
                tok = int(emitted[j])
                self._positions[slot] += 1
                self.block_pool.note_filled(
                    sl.req.req_id, int(self._positions[slot])
                )
                sampled += 1
                self.accepted_tokens += 1
                kept_last = tok
                if self._append_token(slot, tok, finished):
                    done = True
                    break
            if not done and kept_last is not None:
                self._next_token[slot] = kept_last
        return sampled

    def step(self) -> List[GenResult]:
        """One scheduler iteration: admit -> one prefill chunk ->
        (grow/preempt) -> one decode window.  Returns the sequences
        that finished."""
        if self._params is None:
            raise RuntimeError(
                "sync_weights() before step() — the scheduler has no "
                "params to serve with"
            )
        finished: List[GenResult] = []
        self._admit()
        self._prefill_one(finished)
        self._admit()  # a first-token EOS may have freed a slot
        self._ensure_blocks()
        if self.decode_k > 1:
            self._decode_multi_once(finished)
        else:
            self._decode_once(finished)
        self._admit()
        self.iterations += 1
        return finished

    def run(self, max_iterations: int = 1_000_000) -> List[GenResult]:
        """Drive until idle (offline / bench mode)."""
        out: List[GenResult] = []
        for _ in range(max_iterations):
            if self.idle:
                break
            out.extend(self.step())
        return out
