"""Host-offloaded AdamW: the optimizer state lives in host memory.

Port of ``dlrover_tpu/optimizers/host_offload.py``.  The card holds only
the **bf16 compute params** (and their grads); the fp32 master params
and the AdamW moments live in host memory.  Each update streams CHUNKS
of (master, mu, nu) through the card, at most ``DEFAULT_CHUNK_ELEMS``
elements a chunk: host -> card, the AdamW math on the card with the
chunk's grads, the bf16 param chunk out, and the updated state back to
the host.  Chunking bounds the card's share of the update to a fixed set
of chunk buffers whatever the leaf size.

Host memory.  On the card the host state is page-locked: one block of
CPU memory per state, registered with ``cudaHostRegister`` (exact size,
where the caching pinned allocator rounds up to a power of two), and the
leaves are views of it, so ``is_pinned()`` holds for each.  A failed
registration raises, and so does a step handed host state that is not
pinned: there is no pageable path.  On the CPU (``device="cpu"``, the
tests) the host state is plain tensors, the reference's ``numpy``
backend, and the "card side" of each chunk is a copy on the CPU.

The stream on the card.  Each chunk's host -> card copies run
``non_blocking`` on a copy stream of their own (``h2d``), its update on
an update stream, and its card -> host copies on a third stream
(``d2h``), so the two directions of the link run at once.  CUDA events
order them: a chunk's update waits for its inputs (and, once, for the
grads), its copy back waits for its update, and a chunk buffer is
refilled only after its last chunk's copy back.  ``max_in_flight`` chunk
buffers are allocated once and recycled (the reference's donation has no
counterpart here), so at most that many chunks are on the card at once.
The host queues the whole stream without waiting for the card.

The update math:

- fp32 moments: torch ops on the chunk (the reference's chunk update is
  jnp inside a jit, not a Pallas kernel), in the reference's order;
- int8 moments (``moments="int8"``, nu stored as sqrt(nu), one fp32
  scale per 1,024 elements): the port's fused int8 Adam kernel B9
  (``ops.quantization.fused_int8_adam_update``: dequantize, moments,
  update, requantize) on the chunk's blocks, then one pass for weight
  decay and the apply.  B9 rounds ``(b2 * r) * r`` where the reference's
  chunk rounds ``b2 * (r * r)`` (``host_offload.py:224``), so a payload
  may land one count apart from the JAX chunk's (the tests state the
  limits).

The new bf16 params of a step are written into the storage of the grads
that the step consumes (``donate_grads=True``, as the step builders
call it): the grads of a leaf are read into the chunk's fp32 math before
its param chunk is written over them, so no third bf16 tree is made.

Step builders: ``build_offloaded_train_step`` (``chunked``, ``fused``,
``fused_delayed`` and ``auto``, any of them with ``micro_steps``),
``build_fused_offload_step`` and ``build_grouped_offload_step``.  The
reference's "fused" form puts the chunk stream inside one XLA program so
that its copies hide under the backward; here the chunk stream runs on
its side streams while the backward's kernels run on the compute stream.
``delayed=True`` applies the previous step's grads while this step's
backward runs, with the reference's exact semantics.

Switches, with the reference's names and defaults:
``DLROVER_TPU_OFFLOAD_BUFFERED`` (``=0``: the one-shot first-window
prefetch in place of the rolling window) and
``DLROVER_TPU_OFFLOAD_QUANT`` (fp32 moments crossing the host boundary
as int8 + scales; its decision table puts the card where the reference
has ``pinned_host``, so it is off on the card and, on the CPU, on only
with ``=1``).

Left out: the reference's ``DLROVER_TPU_OFFLOAD_WINDOW`` and
``DLROVER_TPU_OFFLOAD_XLA_OPTS`` (XLA program options), the fused
builder's ``window`` argument (one setting bounds the chunks on the card
here: the optimizer's ``max_in_flight``), ``DLROVER_TPU_GROUPED_DEBUG``,
and the completion barriers its runtime needed (CUDA orders the work by
streams and events).
"""

import os
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.quantization import (
    BLOCK as _QBLOCK,
    bias_corrections,
    fused_int8_adam_update,
)
from dlrover_tpu_torch.common.tree import (
    leaves_like,
    tree_leaves,
    tree_map,
    unflatten_like,
)

# 64 Mi elements = 256 MB per fp32 chunk buffer
DEFAULT_CHUNK_ELEMS = 64 * 1024 * 1024

#: ``=0`` restores the one-shot first-window prefetch (instead of the
#: rolling window that refills as chunks are consumed)
OFFLOAD_BUFFERED_ENV = "DLROVER_TPU_OFFLOAD_BUFFERED"
#: quantized TRANSFERS of fp32 moments: ``=0`` forces the fp32 wire,
#: ``=1`` int8 + scales, unset = the reference's default by backend
#: (off on the card and on the CPU)
OFFLOAD_QUANT_ENV = "DLROVER_TPU_OFFLOAD_QUANT"

_ALIGN = 256  # bytes: every view of a host block starts on this


def _buffered_enabled() -> bool:
    return os.getenv(OFFLOAD_BUFFERED_ENV, "1") != "0"


class OffloadState(NamedTuple):
    """Train state of the offloaded path.  ``params``: the bf16 tree on
    the device.  ``master``: fp32 host tensors shaped like the params.
    ``mu``/``nu``: fp32 host tensors shaped like the params, or, with
    int8 moments, per-leaf LISTS of ``(int8 payload [padded], fp32
    scales [padded / 1024])`` host tuples, one per chunk (the payload
    padded to whole 1,024-element blocks), as in the reference."""

    step: int
    params: Dict
    master: Dict
    mu: Dict
    nu: Dict


# ------------------------------------------------------------ host memory


class _PinnedBlock:
    """One block of CPU memory registered with ``cudaHostRegister``.
    Every view handed out holds the block, so it goes when the last view
    does: it is unregistered first, then its memory freed (memory freed
    while registered would stay pinned, lost to the host)."""

    #: bytes registered now, and the error codes of failed unregisters
    registered_bytes = 0
    unregister_errors = []

    def __init__(self, nbytes: int):
        self.nbytes = max(int(nbytes), 1)
        self.buf = torch.zeros(self.nbytes, dtype=torch.uint8)
        self.ptr = self.buf.data_ptr()
        self._cudart = torch.cuda.cudart()
        err = self._cudart.cudaHostRegister(self.ptr, self.nbytes, 0)
        if int(err) != 0:
            self._cudart = None
            raise RuntimeError(
                f"cudaHostRegister of {self.nbytes} bytes of host memory "
                f"failed (CUDA error {int(err)}): the offloaded state "
                "needs page-locked host memory")
        _PinnedBlock.registered_bytes += self.nbytes

    def __del__(self):
        if getattr(self, "_cudart", None) is not None:
            err = int(self._cudart.cudaHostUnregister(self.ptr))
            if err:
                _PinnedBlock.unregister_errors.append(err)
            else:
                _PinnedBlock.registered_bytes -= self.nbytes

    def view(self, offset: int, shape, dtype) -> torch.Tensor:
        n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
        size = n * torch.empty((), dtype=dtype).element_size()
        t = self.buf[offset:offset + size].view(dtype).view(shape)
        t._pinned_block = self  # the block lives as long as its views
        return t


def _host_tensors(specs, device: torch.device):
    """Zeroed host tensors for ``[(shape, dtype), ...]``: on the card
    views of one page-locked block, on the CPU plain tensors."""
    if device.type != "cuda":
        return [torch.zeros(shape, dtype=dtype) for shape, dtype in specs]
    sizes = []
    for shape, dtype in specs:
        n = int(np.prod(shape, dtype=np.int64)) if len(shape) else 1
        size = n * torch.empty((), dtype=dtype).element_size()
        sizes.append(-(-size // _ALIGN) * _ALIGN)
    block = _PinnedBlock(sum(sizes))
    out, off = [], 0
    for (shape, dtype), size in zip(specs, sizes):
        out.append(block.view(off, shape, dtype))
        off += size
    return out


def host_bytes(state) -> int:
    """Bytes of host memory a state's master and moments hold."""
    total = 0
    for part in (state.master, state.mu, state.nu):
        for t in tree_leaves(part):
            total += t.numel() * t.element_size()
    return total


# ------------------------------------------------------------- the math


def _adamw_chunk_math(master, mu, nu, grad, bc1, bc2, *, lr, b1, b2, eps,
                      wd):
    """THE AdamW update over one fp32 chunk, in place on ``master``,
    ``mu`` and ``nu``; returns ``master``.  ``bc1``/``bc2`` are 0-dim
    fp32 tensors (a true division on the card, where a division by a
    Python float is a multiply by its reciprocal).  The reference's
    order: ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g g``,
    ``update = (mu / bc1) / (sqrt(nu / bc2) + eps) [+ wd master]``,
    ``master -= lr update``."""
    g = grad.float()
    mu.mul_(b1).add_(g * (1.0 - b1))
    nu.mul_(b2).add_(g * (1.0 - b2) * g)
    del g
    update = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(eps))
    if wd:
        update.add_(master * wd)
    return master.sub_(update.mul_(lr))


def _adamw_chunk_int8(master, mu_q, mu_s, nu_q, nu_s, grad, bc1, bc2, *, lr,
                      b1, b2, eps, wd):
    """AdamW over one chunk with int8 moments: B9 (dequantize mu and
    sqrt(nu), the moments, ``-lr (mu / bc1) / (sqrt(nu / bc2) + eps)``,
    requantize, in place on the payloads and scales) on the chunk's
    blocks, then weight decay and the apply on ``master``.  Payloads are
    ``[blocks * 8, 128]``, scales ``[blocks, 1]``; ``bc1``/``bc2`` are
    the fp32 bias corrections as Python floats."""
    n = master.numel()
    flat = grad.reshape(-1).float()
    if flat.data_ptr() == grad.data_ptr():
        flat = flat.clone()  # fp32 grads: the update goes into a copy
    upd = fused_int8_adam_update(
        flat, mu_q, mu_s, nu_q, nu_s, ((n,), n), bc1, bc2, lr=lr, b1=b1,
        b2=b2, eps=eps, out=flat, inplace=True, blocks=mu_s.shape[0])[0]
    if wd:
        upd.sub_(master, alpha=lr * wd)
    return master.add_(upd)


def _host_quant_chunk(x: torch.Tensor):
    """fp32 ``[n]`` host tensor -> ``(int8 [padded], fp32 scales)`` with
    the reference's host-side mirror (``_np_quant_chunk``): ``absmax /
    127`` a true division, round half to even.  The quantized wire of
    fp32 moments (``DLROVER_TPU_OFFLOAD_QUANT=1``)."""
    n = x.numel()
    pad = (-n) % _QBLOCK
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    blocks = x.reshape(-1, _QBLOCK)
    scales = torch.clamp_min(
        blocks.abs().amax(dim=1) / torch.tensor(127.0), 1e-12)
    q = torch.clamp(torch.round(blocks / scales[:, None]), -127, 127)
    return q.to(torch.int8).reshape(-1), scales


def _host_deq_chunk(q: torch.Tensor, scales: torch.Tensor, n: int):
    """The reference's ``_np_deq_chunk``: int8 and scales -> fp32
    ``[n]``."""
    x = q.float().reshape(-1, _QBLOCK) * scales.reshape(-1, 1)
    return x.reshape(-1)[:n]


def _q_padded(n: int) -> int:
    return -(-n // _QBLOCK) * _QBLOCK


def _q_views(q: torch.Tensor, s: torch.Tensor):
    """A chunk's payload and scales in the layout B9 takes."""
    return q.view(-1, 128), s.view(-1, 1)


# ------------------------------------------------------- the chunk stream


class _RollingPrefetch:
    """Rolling host -> device window over the chunk sequence: the
    first ``max_in_flight`` chunks are staged at once, and each chunk
    copied back stages the chunk ``max_in_flight`` places on, so the
    transfers of the
    next chunks overlap the chunks in flight.  Each host chunk is read
    ahead of its own copy back only (written once, after its own
    update), so early staging never sees a torn update."""

    def __init__(self, opt, leaves_m, leaves_mu, leaves_nu, quant: bool):
        self._opt = opt
        self._m, self._mu, self._nu = leaves_m, leaves_mu, leaves_nu
        self._quant = quant
        self._entries: Dict = {}
        self._order = opt._order(leaves_m)
        self._cursor = 0
        for _ in range(opt.max_in_flight):
            self._dispatch_next()

    def _dispatch_next(self):
        if self._cursor >= len(self._order):
            return
        k, li, j, sl = self._order[self._cursor]
        self._cursor += 1
        self._entries[(li, j)] = self._opt._stage_chunk(
            self._m, self._mu, self._nu, k, li, j, sl, quant=self._quant)

    def get(self, key):
        """One chunk's staged inputs (None if not staged)."""
        return self._entries.pop(key, None)

    def advance(self):
        """A chunk went back to the host: stage the next one."""
        self._dispatch_next()

    def __len__(self):
        return len(self._entries)


class _OneShotPrefetch(dict):
    """The first-window prefetch (``DLROVER_TPU_OFFLOAD_BUFFERED=0``).
    Carries the staging-time quant flag, so the update unpacks the
    staged tuples with the arity they were built with even if
    ``DLROVER_TPU_OFFLOAD_QUANT`` flips in between."""

    def __init__(self, quant: bool):
        super().__init__()
        self._quant = quant

    def advance(self):
        pass


class _CardStreams:
    """The card's side of the chunk stream: three streams and
    ``max_in_flight`` chunk buffers, allocated once and recycled."""

    def __init__(self, device: torch.device):
        self.device = device
        self.h2d = torch.cuda.Stream(device)
        # the highest priority: a chunk's update kernels take SMs as the
        # backward's blocks free them, instead of waiting for a whole
        # kernel of the backward, and the copies behind them wait less
        self.upd = torch.cuda.Stream(device, priority=-1)
        self.d2h = torch.cuda.Stream(device)
        self.slots = []
        self.slot_free = []  # per buffer: the event of its last copy back
        self.key = None

    def ensure(self, n_slots: int, elems: int, int8: bool):
        """``n_slots`` buffers of at least ``elems`` elements; kept when
        the ones there are big enough."""
        if self.key is not None and self.key[0] == n_slots and \
                self.key[1] >= elems and self.key[2] == int8:
            return
        torch.cuda.synchronize(self.device)
        dev = self.device
        padded = _q_padded(elems)
        self.slots = []
        for _ in range(n_slots):
            slot = {"m": torch.empty(elems, dtype=torch.float32, device=dev)}
            if int8:
                for k in ("mu", "nu"):
                    slot[f"{k}_q"] = torch.empty(padded, dtype=torch.int8,
                                                 device=dev)
                    slot[f"{k}_s"] = torch.empty(padded // _QBLOCK,
                                                 dtype=torch.float32,
                                                 device=dev)
            else:
                slot["mu"] = torch.empty(elems, dtype=torch.float32,
                                         device=dev)
                slot["nu"] = torch.empty(elems, dtype=torch.float32,
                                         device=dev)
            self.slots.append(slot)
        self.slot_free = [None] * n_slots
        self.key = (n_slots, elems, int8)

    def bytes(self) -> int:
        return sum(t.numel() * t.element_size() for s in self.slots
                   for t in s.values())


class _StagedCard(NamedTuple):
    slot: int
    ready: torch.cuda.Event  # the chunk's inputs are on the card


class HostOffloadAdamW:
    """AdamW whose fp32 state never resides on the card.

    Not a ``torch.optim.Optimizer``: those update device-resident state,
    which is what offload avoids.  Use the step builders below, or
    ``init`` / ``start_prefetch`` / ``apply_gradients`` directly.
    ``device`` (default: the card; ``"cpu"`` for the plain path) is where
    the params, the grads and the chunk math live.  ``time_copies``
    records a timing event pair around each chunk's copies (read by
    :meth:`copy_times`).
    """

    def __init__(
        self,
        learning_rate: float = 1e-3,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        chunk_elems: int = DEFAULT_CHUNK_ELEMS,
        max_in_flight: int = 2,
        moments: str = "fp32",
        device: DeviceLike = None,
        time_copies: bool = False,
    ):
        self.lr = learning_rate
        self.b1 = b1
        self.b2 = b2
        self.eps = eps
        self.wd = weight_decay
        self.chunk = int(chunk_elems)
        self.max_in_flight = max(1, int(max_in_flight))
        if moments not in ("fp32", "int8"):
            raise ValueError(f"unknown moments dtype {moments!r}")
        self.moments = moments
        self.device = resolve_device(device)
        self.time_copies = time_copies
        self._card = (_CardStreams(self.device)
                      if self.device.type == "cuda" else None)
        self._params_ready = None  # event: the last stream's params
        self._stream_end = None  # event: the last stream's copies back
        self._pending_spans = []  # the card's streams not yet reported
        self._pending_start = None  # event: the current stream's start
        self._copy_events = {"h2d": [], "d2h": []}
        #: bytes of the last stream, each way; host seconds its queueing
        #: took (on the card the stream runs on after it returns)
        self.last_stream_bytes = 0
        self.last_issue_s = 0.0

    # ---------------------------------------------------------- layout
    def _chunk_slices(self, n: int):
        return [slice(lo, min(lo + self.chunk, n))
                for lo in range(0, n, self.chunk)]

    def _order(self, leaves_m):
        """``(k, leaf, chunk, slice)`` over every chunk, in stream
        order."""
        out = []
        for li, m in enumerate(leaves_m):
            for j, sl in enumerate(self._chunk_slices(m.numel())):
                out.append((len(out), li, j, sl))
        return out

    # ------------------------------------------------------------ init
    def init(self, params) -> OffloadState:
        """``params``: a tree of tensors on any device.  The master
        copies (fp32) and the zero moments go to host memory (pinned on
        the card); the returned ``params`` are bf16 on the device."""
        leaves = tree_leaves(params)
        # every master first, then the moments leaf by leaf (the order
        # they are taken below)
        specs = [(tuple(p.shape), torch.float32) for p in leaves]
        int8 = self.moments == "int8"
        for p in leaves:
            if not int8:
                specs += [(tuple(p.shape), torch.float32)] * 2
                continue
            for sl in self._chunk_slices(p.numel()):
                padded = _q_padded(sl.stop - sl.start)
                specs += [((padded,), torch.int8),
                          ((padded // _QBLOCK,), torch.float32)] * 2
        host = iter(_host_tensors(specs, self.device))
        master, mu, nu, bf16 = [], [], [], []
        for p in leaves:
            m = next(host)
            m.copy_(p.detach().reshape(m.shape))
            master.append(m)
            bf16.append(p.detach().to(device=self.device,
                                      dtype=torch.bfloat16, copy=True))
        for p in leaves:
            if int8:
                chunks_mu, chunks_nu = [], []
                for _ in self._chunk_slices(p.numel()):
                    chunks_mu.append((next(host), next(host)))
                    chunks_nu.append((next(host), next(host)))
                mu.append(chunks_mu)
                nu.append(chunks_nu)
            else:
                mu.append(next(host))
                nu.append(next(host))
        return OffloadState(
            step=0,
            params=unflatten_like(params, bf16),
            master=unflatten_like(params, master),
            mu=unflatten_like(params, mu),
            nu=unflatten_like(params, nu),
        )

    def pin_state(self, state: OffloadState) -> OffloadState:
        """``state`` with its host tensors copied into freshly
        allocated host memory of this optimizer's kind (page-locked on
        the card): a snapshot or a carried state made of plain tensors
        becomes one a card step takes."""
        parts = [state.master, state.mu, state.nu]
        flat = [t for part in parts for t in tree_leaves(part)]
        fresh = _host_tensors(
            [(tuple(t.shape), t.dtype) for t in flat], self.device)
        for dst, src in zip(fresh, flat):
            dst.copy_(src)
        it = iter(fresh)
        master, mu, nu = (unflatten_like(p, [next(it) for _ in
                                             tree_leaves(p)])
                          for p in parts)
        params = tree_map(
            lambda t: t.to(device=self.device, dtype=torch.bfloat16),
            state.params)
        return OffloadState(int(state.step), params, master, mu, nu)

    # ------------------------------------------------------ the stream
    def _transfer_quant(self) -> bool:
        """Whether fp32 moments cross the host boundary quantized.  The
        reference's decision table with the card in the place of
        ``pinned_host``: int8 moments already travel quantized, the card
        never quantizes the wire, and on the CPU ``=0`` is off, ``=1``
        on, unset off (the reference's default off a TPU)."""
        if self.moments != "fp32" or self.device.type == "cuda":
            return False
        return os.getenv(OFFLOAD_QUANT_ENV, "") == "1"

    def _leaves(self, state):
        leaves_m = tree_leaves(state.master)
        leaves_mu = leaves_like(state.master, state.mu)
        leaves_nu = leaves_like(state.master, state.nu)
        return leaves_m, leaves_mu, leaves_nu

    def _card_setup(self, leaves_m, leaves_mu, leaves_nu):
        """The chunk buffers for these leaves, and the check that every
        host tensor is page-locked (a pageable one raises: a copy from
        it would not overlap anything)."""
        elems = max([min(self.chunk, m.numel()) for m in leaves_m] + [0])
        self._card.ensure(self.max_in_flight, elems, self.moments == "int8")
        for t in tree_leaves([leaves_m, leaves_mu, leaves_nu]):
            if t.device.type != "cpu" or not t.is_pinned():
                raise ValueError(
                    "offloaded state on the card needs page-locked host "
                    "memory (HostOffloadAdamW.init or pin_state); got a "
                    f"{'pageable' if t.device.type == 'cpu' else t.device}"
                    " tensor")

    @staticmethod
    def _event():
        return torch.cuda.Event(enable_timing=True)

    def _stage_chunk(self, leaves_m, leaves_mu, leaves_nu, k: int, li: int,
                     j: int, sl: slice, quant: bool = False):
        """Start the host -> device copy of chunk ``k`` (leaf ``li``,
        chunk ``j``).  On the CPU: the chunk's inputs, copied (and, on
        the quantized wire, quantized: nu as sqrt(nu), the int8-moment
        convention).  On the card: the copies into buffer ``k %
        max_in_flight`` on the copy stream, behind that buffer's last copy
        back; returns the buffer and the event of its inputs."""
        flat_m = leaves_m[li].reshape(-1)
        int8 = self.moments == "int8"
        if self._card is None:
            if int8:
                (mu_q, mu_s), (nu_q, nu_s) = leaves_mu[li][j], leaves_nu[li][j]
                return (flat_m[sl].clone(), mu_q.clone(), mu_s.clone(),
                        nu_q.clone(), nu_s.clone())
            flat_mu = leaves_mu[li].reshape(-1)
            flat_nu = leaves_nu[li].reshape(-1)
            if quant:
                return (flat_m[sl].clone(),
                        *_host_quant_chunk(flat_mu[sl]),
                        *_host_quant_chunk(torch.sqrt(flat_nu[sl])))
            return (flat_m[sl].clone(), flat_mu[sl].clone(),
                    flat_nu[sl].clone())
        card = self._card
        s = k % self.max_in_flight
        slot = card.slots[s]
        n = sl.stop - sl.start
        with torch.cuda.stream(card.h2d):
            if card.slot_free[s] is not None:
                card.h2d.wait_event(card.slot_free[s])
            t0 = self._event()
            t0.record(card.h2d)
            if self._pending_start is None:
                self._pending_start = t0
            slot["m"][:n].copy_(flat_m[sl], non_blocking=True)
            if int8:
                for name, leaves in (("mu", leaves_mu), ("nu", leaves_nu)):
                    q, sc = leaves[li][j]
                    slot[f"{name}_q"][:q.numel()].copy_(q, non_blocking=True)
                    slot[f"{name}_s"][:sc.numel()].copy_(sc,
                                                        non_blocking=True)
            else:
                slot["mu"][:n].copy_(leaves_mu[li].reshape(-1)[sl],
                                     non_blocking=True)
                slot["nu"][:n].copy_(leaves_nu[li].reshape(-1)[sl],
                                     non_blocking=True)
            ready = self._event()
            ready.record(card.h2d)
        if self.time_copies:
            self._copy_events["h2d"].append((t0, ready))
        return _StagedCard(s, ready)

    def start_prefetch(self, state):
        """Start the host -> device stream of the state (before the
        backward, so that the first chunks' copies overlap it); the
        returned object feeds :meth:`apply_gradients`.  A rolling
        window by default; ``DLROVER_TPU_OFFLOAD_BUFFERED=0`` stages only
        the first window (the reference's one-shot dict)."""
        self._emit_pending_span()
        leaves_m, leaves_mu, leaves_nu = self._leaves(state)
        quant = self._transfer_quant()
        if self._card is not None:
            self._card_setup(leaves_m, leaves_mu, leaves_nu)
        self._pending_start = None
        if _buffered_enabled():
            return _RollingPrefetch(self, leaves_m, leaves_mu, leaves_nu,
                                    quant)
        prefetched = _OneShotPrefetch(quant)
        for k, li, j, sl in self._order(leaves_m)[:self.max_in_flight]:
            prefetched[(li, j)] = self._stage_chunk(
                leaves_m, leaves_mu, leaves_nu, k, li, j, sl, quant=quant)
        return prefetched

    def _stream(self, state, grads, bc1: float, bc2: float, wd: float,
                prefetched=None, donate: bool = False, ready=None,
                wait: bool = True):
        """One streamed AdamW update of ``state``'s host state with
        ``grads``; returns the new bf16 params (in the grads' storage
        where ``donate`` and the grads are contiguous bf16 on the
        device).  On the card ``ready`` is the event after which the
        grads may be read (default: now, on the current stream); with
        ``wait`` the current stream waits for the new params, else the
        caller waits on :meth:`params_ready`."""
        leaves_m, leaves_mu, leaves_nu = self._leaves(state)
        leaves_p = tree_leaves(state.params)
        leaves_g = leaves_like(state.params, grads)
        if not isinstance(prefetched, (_RollingPrefetch, _OneShotPrefetch)):
            self._emit_pending_span()
            prefetched = None
        quant = (prefetched._quant if prefetched is not None
                 else self._transfer_quant())
        buffered = isinstance(prefetched, _RollingPrefetch)
        card = self._card
        if card is not None and prefetched is None:
            self._card_setup(leaves_m, leaves_mu, leaves_nu)
            self._pending_start = None
        int8 = self.moments == "int8"
        dev = self.device
        outs = []
        for p, g in zip(leaves_p, leaves_g):
            if (donate and g.dtype == torch.bfloat16 and g.is_contiguous()
                    and g.device == dev and g.numel() == p.numel()):
                outs.append(g)
            else:
                outs.append(torch.empty(tuple(p.shape), dtype=torch.bfloat16,
                                        device=dev))
        hyper = dict(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps, wd=wd)
        if card is None:
            bc1_t = torch.tensor(bc1, dtype=torch.float32)
            bc2_t = torch.tensor(bc2, dtype=torch.float32)
        else:
            if ready is None:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            card.upd.wait_event(ready)
            for t in leaves_g + outs:
                t.record_stream(card.upd)
            with torch.cuda.stream(card.upd):
                # fills on the update stream: no copy, no sync
                bc1_t = torch.full((), bc1, dtype=torch.float32, device=dev)
                bc2_t = torch.full((), bc2, dtype=torch.float32, device=dev)
        t_start = time.perf_counter()
        stream_bytes = 0
        order = self._order(leaves_m)
        for k, li, j, sl in order:
            staged = prefetched.get((li, j)) if prefetched is not None \
                else None
            if staged is None:
                staged = self._stage_chunk(leaves_m, leaves_mu, leaves_nu, k,
                                           li, j, sl, quant=quant)
            n = sl.stop - sl.start
            grad = leaves_g[li].reshape(-1)[sl]
            out = outs[li].reshape(-1)[sl]
            if card is None:
                self._update_cpu(staged, grad, out, leaves_m, leaves_mu,
                                 leaves_nu, li, j, sl, bc1, bc2, bc1_t, bc2_t,
                                 hyper, quant)
            else:
                self._update_card(staged, grad, out, leaves_m, leaves_mu,
                                  leaves_nu, li, j, sl, bc1, bc2, bc1_t,
                                  bc2_t, hyper, last=k == len(order) - 1)
            if int8 or quant:
                padded = _q_padded(n)
                stream_bytes += 2 * (4 * n + 2 * (padded + 4 * (
                    padded // _QBLOCK)))
            else:
                stream_bytes += 2 * (4 * n + 2 * 4 * n)
            if prefetched is not None:
                prefetched.advance()
        self.last_stream_bytes = stream_bytes
        self.last_issue_s = time.perf_counter() - t_start
        if card is None:
            self._emit_stream_span(time.perf_counter() - t_start,
                                   stream_bytes, buffered)
        else:
            self._pending_spans.append((self._pending_start,
                                        self._stream_end, stream_bytes,
                                        buffered))
            if wait:
                torch.cuda.current_stream(dev).wait_event(self._params_ready)
        return unflatten_like(state.params,
                              [o.view(p.shape) for o, p in zip(outs,
                                                               leaves_p)])

    def _update_cpu(self, staged, grad, out, leaves_m, leaves_mu, leaves_nu,
                    li, j, sl, bc1, bc2, bc1_t, bc2_t, hyper, quant):
        """The chunk update and its writeback, on the CPU."""
        n = sl.stop - sl.start
        if self.moments == "int8" or quant:
            m, mu_q, mu_s, nu_q, nu_s = staged
            _adamw_chunk_int8(m, *_q_views(mu_q, mu_s), *_q_views(nu_q, nu_s),
                              grad, bc1, bc2, **hyper)
            out.copy_(m)
            leaves_m[li].reshape(-1)[sl].copy_(m)
            if quant:
                # the quantized wire back into the SAME fp32 host state
                leaves_mu[li].reshape(-1)[sl].copy_(
                    _host_deq_chunk(mu_q, mu_s, n))
                root = _host_deq_chunk(nu_q, nu_s, n)
                leaves_nu[li].reshape(-1)[sl].copy_(root * root)
            else:
                for (q, s), (q2, s2) in ((leaves_mu[li][j], (mu_q, mu_s)),
                                         (leaves_nu[li][j], (nu_q, nu_s))):
                    q.copy_(q2.reshape(-1))
                    s.copy_(s2.reshape(-1))
            return
        m, mu, nu = staged
        _adamw_chunk_math(m, mu, nu, grad, bc1_t, bc2_t, **hyper)
        out.copy_(m)
        leaves_m[li].reshape(-1)[sl].copy_(m)
        leaves_mu[li].reshape(-1)[sl].copy_(mu)
        leaves_nu[li].reshape(-1)[sl].copy_(nu)

    def _update_card(self, staged, grad, out, leaves_m, leaves_mu, leaves_nu,
                     li, j, sl, bc1, bc2, bc1_t, bc2_t, hyper, last):
        """The chunk update on the update stream, then its copy back on
        the other copy stream; the buffer is free again after it."""
        card = self._card
        s = staged.slot
        slot = card.slots[s]
        n = sl.stop - sl.start
        with torch.cuda.stream(card.upd):
            card.upd.wait_event(staged.ready)
            m = slot["m"][:n]
            if self.moments == "int8":
                nb = _q_padded(n) // _QBLOCK
                mu_q, mu_s = _q_views(slot["mu_q"][:nb * _QBLOCK],
                                      slot["mu_s"][:nb])
                nu_q, nu_s = _q_views(slot["nu_q"][:nb * _QBLOCK],
                                      slot["nu_s"][:nb])
                _adamw_chunk_int8(m, mu_q, mu_s, nu_q, nu_s, grad, bc1, bc2,
                                  **hyper)
            else:
                _adamw_chunk_math(m, slot["mu"][:n], slot["nu"][:n], grad,
                                  bc1_t, bc2_t, **hyper)
            out.copy_(m)
            done = self._event()
            done.record(card.upd)
        if last:
            self._params_ready = done
        with torch.cuda.stream(card.d2h):
            card.d2h.wait_event(done)
            t0 = self._event()
            t0.record(card.d2h)
            leaves_m[li].reshape(-1)[sl].copy_(m, non_blocking=True)
            if self.moments == "int8":
                for name, leaves in (("mu", leaves_mu), ("nu", leaves_nu)):
                    q, sc = leaves[li][j]
                    q.copy_(slot[f"{name}_q"][:q.numel()], non_blocking=True)
                    sc.copy_(slot[f"{name}_s"][:sc.numel()],
                             non_blocking=True)
            else:
                leaves_mu[li].reshape(-1)[sl].copy_(slot["mu"][:n],
                                                    non_blocking=True)
                leaves_nu[li].reshape(-1)[sl].copy_(slot["nu"][:n],
                                                    non_blocking=True)
            free = self._event()
            free.record(card.d2h)
        card.slot_free[s] = free
        if self.time_copies:
            self._copy_events["d2h"].append((t0, free))
        if last:
            self._stream_end = free

    # -------------------------------------------------------- the step
    def apply_gradients(self, state: OffloadState, grads, prefetched=None,
                        donate_grads: bool = False) -> OffloadState:
        """One AdamW step.  ``grads``: a tree like ``state.params`` on the
        device.  Streams the chunks; the host buffers are updated in
        place.  ``prefetched``: the window of :meth:`start_prefetch`.
        ``donate_grads``: the new bf16 params may take the grads'
        storage (the grads are consumed).  On the card the current stream
        waits for the new params; the host state is written when
        :meth:`synchronize` returns."""
        step = state.step + 1
        # the reference's bias correction here: 1 - b**step in float64,
        # then float32
        bc1 = float(np.float32(1.0 - self.b1 ** step))
        bc2 = float(np.float32(1.0 - self.b2 ** step))
        params = self._stream(state, grads, bc1, bc2, self.wd, prefetched,
                              donate=donate_grads)
        return OffloadState(step=step, params=params, master=state.master,
                            mu=state.mu, nu=state.nu)

    def params_ready(self):
        """The event after which the last stream's params are on the
        card (None on the CPU or before a stream)."""
        return self._params_ready

    def synchronize(self):
        """Wait until the last stream's state is back in host memory,
        and emit its ``offload_copy`` span."""
        if self._stream_end is not None:
            self._stream_end.synchronize()
        self._emit_pending_span()

    def copy_times(self):
        """``{"h2d": [ms, ...], "d2h": [ms, ...]}``: each chunk's copy
        time on the card's clock since the last call (``time_copies``;
        synchronizes)."""
        self.synchronize()
        out = {k: [a.elapsed_time(b) for a, b in v]
               for k, v in self._copy_events.items()}
        self._copy_events = {"h2d": [], "d2h": []}
        return out

    def _emit_pending_span(self):
        """Emit the spans of the card's finished streams, in order."""
        while self._pending_spans:
            start, end, nbytes, buffered = self._pending_spans[0]
            if not end.query():
                return
            self._pending_spans.pop(0)
            self._emit_stream_span(start.elapsed_time(end) / 1e3, nbytes,
                                   buffered)

    @staticmethod
    def _emit_stream_span(duration_s: float, nbytes: int, buffered: bool):
        """One ``offload_copy`` span per streamed update: the
        host<->device state traffic with its throughput, tagged
        ``buffered``.  Emitted when the stream has ended (its start is
        "now" minus the duration); on the card the duration is the
        stream's on the card's clock, first copy in to last copy back."""
        try:
            from dlrover_tpu_torch.observability.events import (
                anchored_now,
                get_event_logger,
            )
            from dlrover_tpu_torch.observability.metrics import (
                record_offload_io,
            )

            gbps = nbytes / 1e9 / max(duration_s, 1e-9)
            get_event_logger().complete(
                "offload_copy",
                anchored_now() - max(duration_s, 0.0),
                duration_s,
                bytes=int(nbytes),
                throughput_gbps=round(gbps, 3),
                buffered=bool(buffered),
            )
            record_offload_io(nbytes, duration_s, buffered)
        except Exception:  # noqa: BLE001 - observability only
            pass


# ---------------------------------------------------------- gradients


def _to_device(batch, device):
    def put(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device) if isinstance(x, torch.Tensor) else x

    return tree_map(put, batch)


def value_and_grad(loss_fn, params, batch, argnum: Optional[int] = None):
    """``(loss, grads)`` of ``loss_fn(params, batch)`` (``jax.
    value_and_grad``).  With ``argnum``, ``params`` is a sequence of
    group trees passed as ``loss_fn(*params, batch)`` and only group
    ``argnum`` gets grads."""
    if argnum is None:
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        loss = loss_fn(unflatten_like(params, leaves), batch)
        target = params
    else:
        groups = []
        for i, part in enumerate(params):
            if i == argnum:
                leaves = [t.detach().requires_grad_()
                          for t in tree_leaves(part)]
                groups.append(unflatten_like(part, leaves))
            else:
                groups.append(tree_map(torch.Tensor.detach, part))
        loss = loss_fn(*groups, batch)
        target = params[argnum]
    grads = torch.autograd.grad(loss, leaves)
    grads = [g.contiguous() for g in grads]
    return loss.detach(), unflatten_like(target, grads)


def _split(batch, k: int, i: int):
    return tree_map(
        lambda x: x.reshape((k, x.shape[0] // k) + tuple(x.shape[1:]))[i],
        batch)


def make_accumulated_grads_fn(loss_fn, micro_steps: int):
    """``(params, batch) -> (mean loss, mean grads)`` over
    ``micro_steps`` microbatches (the batch's leading dim splits
    evenly).  The stream update is the expensive part of an offloaded
    step, so amortizing it over K microbatches is the offload-native
    throughput lever; the accumulator is bf16 (an fp32 one would cost
    4 bytes a param of the memory the offload frees): ``acc = g0 *
    inv``, then ``acc + g_k * inv``, each product and sum rounded to
    bf16, ``inv`` itself a bf16, as in the reference."""
    micro_steps = max(1, int(micro_steps))

    def grads_of(params, batch):
        if micro_steps <= 1:
            return value_and_grad(loss_fn, params, batch)
        loss_sum = None
        acc = None
        inv = 1.0 / micro_steps
        for k in range(micro_steps):
            loss_k, g = value_and_grad(loss_fn, params,
                                       _split(batch, micro_steps, k))
            loss_sum = loss_k if loss_sum is None else loss_sum + loss_k
            if acc is None:
                acc = tree_map(
                    lambda a: a * torch.tensor(inv, dtype=a.dtype), g)
            else:
                tree_map(lambda s, a: s.add_(
                    a * torch.tensor(inv, dtype=a.dtype)), acc, g)
        return loss_sum * inv, acc

    return grads_of


def _release_params(state):
    """Swap the bf16 params for ``meta`` tensors of the same shapes once
    the backward has read them: the update needs only their shapes, and
    dropping the state's reference lets the allocator give the old
    params' memory to the next step's grads (the new params take the
    consumed grads' storage).  Callers pass the state as a temporary
    (``step(holder.pop(), batch)``) so that no other name keeps the old
    params."""
    return state._replace(params=tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
        state.params))


def _done(device):
    """On the card, an event at the end of the step's work on the
    current stream (the ``"done"`` of the step's metrics)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


# ------------------------------------------------------------ builders


class FusedOffloadState(NamedTuple):
    """Train state of the fused path: ``master``/``mu``/``nu`` in the
    layout of :class:`OffloadState`; ``grads`` holds the previous step's
    gradients in delayed mode (None in synchronous mode)."""

    step: int
    params: Dict
    master: Dict
    mu: Dict
    nu: Dict
    grads: Optional[Dict]


def build_fused_offload_step(
    loss_fn,
    init_params_fn,
    optimizer: Optional[HostOffloadAdamW] = None,
    delayed: bool = True,
    micro_steps: int = 1,
):
    """:func:`build_offloaded_train_step` in mode ``"fused_delayed"``
    (``delayed=True``, the default) or ``"fused"``."""
    return build_offloaded_train_step(
        loss_fn, init_params_fn, optimizer,
        mode="fused_delayed" if delayed else "fused",
        micro_steps=micro_steps)


def build_offloaded_train_step(
    loss_fn,
    init_params_fn,
    optimizer: Optional[HostOffloadAdamW] = None,
    mode: str = "auto",
    micro_steps: int = 1,
):
    """One-device train step with host-resident optimizer state.

    The reference's fused modes put the update into the train step's XLA
    program so that the compiler overlaps its host copies with the
    backward's matmuls.  Here every mode streams the chunks (copies and
    update math) on the optimizer's side streams, the first chunks'
    copies started before the backward; the optimizer's
    ``max_in_flight`` chunk buffers bound the stream's share of the card.

    ``mode``:

    - ``"auto"`` (default): ``"fused_delayed"`` on the card, else
      ``"chunked"`` (the reference's choice by backend);
    - ``"chunked"`` and ``"fused"``: backward first, then the update
      (exact synchronous AdamW).  They differ only where the reference's
      do: the chunked step's state is an :class:`OffloadState` and its
      bias corrections are ``1 - b**step`` in float64 then fp32
      (:meth:`HostOffloadAdamW.apply_gradients`); the fused step's state
      is a :class:`FusedOffloadState` and its corrections are computed in
      fp32, as the reference's program does;
    - ``"fused_delayed"``: the backward runs on the CURRENT params while
      the stream applies the PREVIOUS step's grads to make the next
      params (ZeRO-Offload's delayed parameter update); on the card the
      stream is queued from a second host thread while this one queues
      the forward and backward, and the step ends when both have.  Step 1
      is a true no-op: there are no previous grads (zeros), weight decay
      is gated off on it, and bias correction counts real updates (step t
      applies the (t-1)-th update), so the trajectory is the synchronous
      one on the grads shifted by one step.

    Every mode takes the grads of ``make_accumulated_grads_fn(loss_fn,
    micro_steps)``.  Returns ``(init_state, train_step)``;
    ``init_state(rng)`` calls ``init_params_fn(rng)``; ``train_step(state,
    batch) -> (state, {"loss"[, "done", "backward_done"]})`` consumes
    ``state`` (pass it as a temporary); on the card ``done`` and
    ``backward_done`` are events at the step's end and its backward's.
    """
    opt = optimizer or HostOffloadAdamW()
    if mode == "auto":
        mode = "fused_delayed" if opt.device.type == "cuda" else "chunked"
    if mode not in ("chunked", "fused", "fused_delayed"):
        raise ValueError(f"unknown offload mode {mode!r}")
    grads_of = make_accumulated_grads_fn(loss_fn, micro_steps)
    dev = opt.device

    def init_state(rng):
        base = opt.init(init_params_fn(rng))
        if mode == "chunked":
            return base
        grads = (tree_map(torch.zeros_like, base.params)
                 if mode == "fused_delayed" else None)
        return FusedOffloadState(0, base.params, base.master, base.mu,
                                 base.nu, grads)

    def train_step(state, batch):
        batch = _to_device(batch, dev)
        step = int(state.step) + 1
        if mode == "fused_delayed":
            # step t applies the grads computed at t - 1: the (t-1)-th
            # real update; step 1 (zero grads) is a no-op
            upd_step = max(step - 1, 1)
            wd = opt.wd if step > 1 else 0.0
            bc1, bc2 = bias_corrections(opt.b1, opt.b2, upd_step)
            applied = state.grads
            shapes = state._replace(grads=None)
            if dev.type == "cuda":
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
                box = {}

                def issue():
                    try:
                        box["params"] = opt._stream(
                            shapes, applied, bc1, bc2, wd,
                            opt.start_prefetch(shapes), donate=True,
                            ready=ready, wait=False)
                    except BaseException as e:  # noqa: BLE001
                        box["error"] = e

                th = threading.Thread(target=issue, daemon=True)
                th.start()
                try:
                    loss, grads = grads_of(state.params, batch)
                finally:
                    th.join()
                if "error" in box:
                    raise box["error"]
                new_params = box["params"]
                backward_done = _done(dev)
                torch.cuda.current_stream(dev).wait_event(
                    opt.params_ready())
            else:
                new_params = opt._stream(shapes, applied, bc1, bc2, wd,
                                         opt.start_prefetch(shapes),
                                         donate=True)
                loss, grads = grads_of(state.params, batch)
                backward_done = None
            new_state = FusedOffloadState(step, new_params, state.master,
                                          state.mu, state.nu, grads)
        else:
            # the first chunks' copies to the card start before backward
            prefetched = opt.start_prefetch(state)
            loss, grads = grads_of(state.params, batch)
            backward_done = _done(dev)
            shapes = _release_params(state)
            del state
            if mode == "chunked":
                new_state = opt.apply_gradients(
                    shapes, grads, prefetched=prefetched, donate_grads=True)
            else:
                bc1, bc2 = bias_corrections(opt.b1, opt.b2, step)
                new_params = opt._stream(shapes, grads, bc1, bc2, opt.wd,
                                         prefetched, donate=True)
                new_state = FusedOffloadState(step, new_params,
                                              shapes.master, shapes.mu,
                                              shapes.nu, None)
        metrics = {"loss": loss}
        done = _done(dev)
        if done is not None:
            # the step's end, and its backward's: the stream's exposed
            # share of the step lies between the two
            metrics["done"] = done
            if backward_done is not None:
                metrics["backward_done"] = backward_done
        return new_state, metrics

    return init_state, train_step


def build_grouped_offload_step(
    loss_grouped,
    init_a_fn=None,
    init_b_fn=None,
    optimizer_a: Optional[HostOffloadAdamW] = None,
    optimizer_b: Optional[HostOffloadAdamW] = None,
    *,
    init_fns: Optional[Sequence] = None,
    optimizers: Optional[Sequence] = None,
):
    """Offloaded train step with N param groups and one backward per
    group: the largest grads tree on the card is one group's, so N trades
    backward passes for memory (``models.llama.offload_group_plan`` asks
    ``accelerate.solver.solve_offload_groups`` for the smallest N that
    fits).

    Semantics are EXACT single-step AdamW: every group's grads are taken
    at the step-start params.  Groups ``0..N-2``'s grads go to host
    memory (pinned on the card) while the later backwards and the last
    group's update run, then come back in reverse order, each into the
    storage its group's new params take.

    Two calling conventions:

    - two groups (positional): ``build_grouped_offload_step(loss, init_a,
      init_b, opt_a, opt_b)`` with ``loss(params_a, params_b, batch)``;
    - N groups: ``build_grouped_offload_step(loss, init_fns=[...],
      optimizers=[...])`` with ``loss(*group_params, batch)``.

    ``init_fns[i]()`` builds group i's params lazily, so each group's
    fp32 source is freed before the next one is made.  Returns
    ``(init_state, train_step)`` over a tuple of per-group
    :class:`OffloadState` (consumed by the step: pass it as a
    temporary).
    """
    if init_fns is None:
        init_fns = [fn for fn in (init_a_fn, init_b_fn) if fn is not None]
        optimizers = [optimizer_a, optimizer_b][:len(init_fns)]
    init_fns = list(init_fns)
    n_groups = len(init_fns)
    if n_groups < 1:
        raise ValueError("need at least one param group")
    if optimizers is None:
        optimizers = [None] * n_groups
    opts = [o or HostOffloadAdamW() for o in optimizers]
    if len(opts) != n_groups:
        raise ValueError(f"{len(opts)} optimizers for {n_groups} groups")
    dev = opts[0].device
    if any(o.device != dev for o in opts):
        raise ValueError("every group's optimizer must be on one device")
    staging: Dict[int, list] = {}  # group -> host tensors for its grads

    def init_state(rng=None):
        del rng  # the group inits carry their own generators
        return tuple(opts[i].init(init_fns[i]()) for i in range(n_groups))

    def stage_out(i, grads):
        """Group i's grads to host memory (reused page-locked buffers on
        the card; on the CPU the tensors themselves)."""
        if dev.type != "cuda":
            return grads
        leaves = tree_leaves(grads)
        host = staging.get(i)
        if host is None:
            host = _host_tensors(
                [(tuple(g.shape), g.dtype) for g in leaves], dev)
            staging[i] = host
        for h, g in zip(host, leaves):
            h.copy_(g, non_blocking=True)
        return unflatten_like(grads, host)

    def stage_in(grads):
        if dev.type != "cuda":
            return grads
        return tree_map(lambda h: h.to(dev, non_blocking=True), grads)

    def train_step(state, batch):
        batch = _to_device(batch, dev)
        states = list(state)
        del state
        step_params = [s.params for s in states]
        loss = None
        staged = []
        # backwards 1..N-1: the early groups' grads at the step-start
        # params, to host memory (one grads tree on the card at a time)
        for i in range(n_groups - 1):
            loss_i, g = value_and_grad(loss_grouped, step_params, batch,
                                       argnum=i)
            if loss is None:
                loss = loss_i
            staged.append(stage_out(i, g))
            del g
        # the last group's grads at the SAME params, applied at once
        last = n_groups - 1
        loss_last, g_last = value_and_grad(loss_grouped, step_params, batch,
                                           argnum=last)
        if loss is None:
            loss = loss_last
        del step_params
        pre = opts[last].start_prefetch(states[last])
        states[last] = _release_params(states[last])
        states[last] = opts[last].apply_gradients(
            states[last], g_last, prefetched=pre, donate_grads=True)
        del g_last, pre
        # the staged grads back, updated in reverse order
        for i in range(n_groups - 2, -1, -1):
            g = stage_in(staged[i])
            staged[i] = None
            pre = opts[i].start_prefetch(states[i])
            states[i] = _release_params(states[i])
            states[i] = opts[i].apply_gradients(states[i], g, prefetched=pre,
                                                donate_grads=True)
            del g, pre
        metrics = {"loss": loss}
        done = _done(dev)
        if done is not None:
            metrics["done"] = done
        return tuple(states), metrics

    return init_state, train_step


# ------------------------------------------------------ the JAX state


def _tensor(a) -> torch.Tensor:
    """A numpy(-convertible) array -> a CPU tensor (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16).copy()).view(
                torch.bfloat16)
    return torch.from_numpy(np.array(a))


def offload_state_from_jax(jax_state, optimizer: HostOffloadAdamW
                           ) -> OffloadState:
    """The JAX package's ``OffloadState`` -> the port's, for
    ``optimizer`` (its device and host memory kind).

    ``jax_state`` has the reference's fields: ``step``, ``params`` (bf16
    arrays), ``master``/``mu``/``nu`` as the numpy backend holds them
    (whole-leaf fp32 arrays; int8 moments as per-leaf lists of
    ``(payload, scales)`` chunks) or as the pinned layout does (per-leaf
    lists of fp32 chunks, concatenated here).  The payload and scales
    layouts are the same, so nothing is re-quantized; the chunking must
    be ``optimizer``'s."""

    def leaf_master(p, m):
        if isinstance(m, (list, tuple)):
            m = np.concatenate([np.asarray(c).reshape(-1) for c in m])
        return _tensor(m).reshape(tuple(np.shape(p))).float()

    def walk(p, m, mu, nu):
        if isinstance(p, dict):
            out = {k: walk(p[k], m[k], mu[k], nu[k]) for k in p}
            return ({k: v[0] for k, v in out.items()},
                    {k: v[1] for k, v in out.items()},
                    {k: v[2] for k, v in out.items()},
                    {k: v[3] for k, v in out.items()})
        params = _tensor(p)
        master = leaf_master(p, m)
        n = master.numel()
        if optimizer.moments == "int8":
            slices = optimizer._chunk_slices(n)
            if len(mu) != len(slices) or len(nu) != len(slices):
                raise ValueError(
                    f"{len(mu)} int8 chunks for {len(slices)} of "
                    f"{optimizer.chunk} elements: set chunk_elems to the "
                    "JAX optimizer's")
            mus = [(_tensor(q), _tensor(s)) for q, s in mu]
            nus = [(_tensor(q), _tensor(s)) for q, s in nu]
            return params, master, mus, nus
        return (params, master, leaf_master(p, mu), leaf_master(p, nu))

    params, master, mu, nu = walk(jax_state.params, jax_state.master,
                                  jax_state.mu, jax_state.nu)
    return optimizer.pin_state(OffloadState(
        int(jax_state.step), params, master, mu, nu))
