"""Continuous batching for decode: a slot-based KV-cache pool with a
pipelined dispatch loop.

Port of ``gofr_tpu/tpu/decode_pool.py``'s core ``DecodePool``. Prefill is
batched by the ``DynamicBatcher``; without the pool each generation then
decodes alone, so N concurrent streams pay N times a step's host cost. The
pool keeps ONE cache of ``n_slots`` rows and a worker that decodes every
slot in one fixed-shape chunk (``Transformer.decode_chunk_pool``) per
dispatch: N streams share one step's launches.

Mechanics:
- a finished prefill's first ``length`` positions are copied into a free
  slot row (only those: no kernel reads a row past its ``kv_len``) and its
  first token into the device-resident token row; nothing else of the row
  is touched;
- the last sampled token of every slot stays on the card, fed forward from
  chunk to chunk, so the worker keeps up to ``pipeline_depth`` eager chunks
  in flight; each dispatch snapshots (slot -> request), so a slot freed and
  reused mid-pipeline never leaks a chunk's tokens to the next request. A
  replayed chunk (below) keeps one in flight: its issue takes the host
  next to nothing, so there is no host lead to hide, and every chunk
  queued ahead on the stream would delay each prefill's sync behind it;
- each chunk's tokens and logprobs start their copy to pinned host memory
  right after the dispatch, with an event recorded behind the copy
  (:class:`HostFetch`); the worker waits on that event alone, so the copy
  is never queued behind a younger chunk. Top-k alternatives are copied
  only when an active request asked for them;
- idle slots decode in lockstep (fixed shapes) and are overwritten on reuse;
  a freed slot's length restarts at 0 (the attention of an idle row reads
  only what it wrote since), then runs on, past ``max_seq`` if it stays
  idle that long, where positions, the cache write and every attention
  kernel clamp;
- on a card, the plain chunk of one unsharded model is captured once into
  two CUDA graphs (``ChunkGraph``, at construction), greedy and sampled
  (the sampled one draws from the pool's generator, registered with it),
  and replayed on every dispatch they serve: one launch in place of
  ~1,800 a step. A graph reads and writes fixed tensors, so nothing
  rebinds them: the cache's ``k``, ``v`` and ``lengths``, the token row
  and the knob vectors are written in place by every path (admissions,
  eager chunks, spec cycles). ``chunk_path`` decides each chunk from what
  the pool observes: adapter and penalized chunks, a sharded model and
  the CPU run the same chunk function eagerly;
- requests with a sampling seed bypass the pool (``device.py`` routes them
  solo: their generator sequence must reproduce);
- penalized requests (repetition/presence/frequency penalties, logit
  bias) join the pool on per-slot state: [slots, V] presence (bool),
  counts (f32) and bias (f32) rows and per-slot knob vectors, written at
  admission; the chunk runs ``decode_chunk_pool_penalized`` only while a
  penalized slot is active (a plain slot carries identity knobs and
  samples as the plain chunk does). ``penalties`` (DECODE_POOL_PENALTIES)
  says when the state exists: ``eager`` at boot, ``lazy`` (the default)
  from the first penalized submit (that request solos, rejected
  ``penalties_warming``, while the worker allocates it), ``off`` never
  (penalized requests solo, rejected ``penalties_off``).

Stream order stands in for JAX's data dependencies. Every CUDA operation
the pool makes runs on the device's default stream, where the prefill that
produces a slot's row (batcher and request threads) ran too, and ONE
thread, the worker, issues them all: ``submit`` only queues an admission
(slot, row, length, first token, knobs) under the pool lock, and the worker
issues its writes before its next dispatch, so they land after every chunk
dispatched before them and before every chunk after. The same thread
issues the chunk dispatches, the copies to the host and the finish-time
row read. A replay overwrites the graph's output buffers, so each chunk's
copies to the host are queued right behind its replay, before the next
dispatch: stream order gives each copy its own chunk's tokens. An eager
chunk's launches take the host hundreds of milliseconds at llama3-8b, so
the worker dispatches outside the lock: a submit or a delivery never waits
for them.

Pooled speculation (``spec``, a ``PoolSpecConfig``: ``SPEC_POOLED``):
a greedy request without penalties or logprobs is armed with an n-gram
draft state (``tpu/spec_pool.py``). While EVERY active row is armed (and no
penalized slot is active) and no chunk is in flight, the worker drafts each
row's next tokens on the host, verifies every row's pending token and
drafts in ONE ``[n_slots, width]`` target forward
(``Transformer.verify_chunk``, width on ``verify_width``'s ladder), fetches
the argmaxes, commits each row's longest matching draft prefix plus the
bonus token, and rolls the rejected tail back by writing every row's
committed length in one copy; the device token row is rebuilt from the
host-tracked pending tokens, so a plain chunk can follow. Spec cycles run
at depth 1 (the host reads a verify before the next dispatch); a cohort
whose drafts keep missing gets its pipeline back after
``SPEC_IDLE_ROUNDS`` dry rounds, and a new armed submit re-opens the
window. Armed rows riding a plain chunk (a mixed cohort) keep their draft
context through ``note_plain``.

Pooled multi-LoRA (``enable_lora``, ``submit(adapter=...)``): adapter
requests decode in the pool through a stacked adapter bank
(``models/lora.py::build_lora_stack``); per-slot ids select each row's
adapter (0 = the zero entry, for base rows), so two adapters and the base
share one chunk (``Transformer.decode_chunk_pool_lora``), run only while an
adapter slot is active. One chunk function a dispatch: adapter and
penalized slots never share a chunk (the ``penalized_adapter``,
``penalized_mix`` and ``adapter_mix`` rejects: those requests decode
solo). A bank rebuilt while adapter slots are live waits for them to
finish (new adapter submits solo meanwhile, ``bank_rebuilding``), so an id
never indexes a bank swapped under it.

Metrics (``metrics``, the app's registry): ``gofr_tpu_decode_slots_active``
at each submit and each delivered chunk or verify,
``gofr_tpu_tokens_total{op="decode"}`` by the tokens each chunk or verify
delivered, ``gofr_tpu_pool_reject_total{reason}`` at each reject, the
spec gauges through ``PoolSpecConfig.note_cycle``, and per delivery
``gofr_tpu_mfu{op="decode"}`` (2·N·tokens delivered over the interval) and
``gofr_tpu_mbu{op="decode"}`` (the weights a step plus the active rows' KV,
over the interval): all from host values (ids already fetched, counts,
lengths, clocks), never a device read.

Observability (``timeline``, ``watchdog``: ``tpu/introspect.py``): every
chunk and verify is a ``decode_chunk`` / ``spec_verify`` dispatch record,
running from its dispatch and done after the host's wait on its copy, so
its duration holds the card's work (a launch returns at once); the riding
requests' flight records get its id, their pool cohort and KV reservation.
The wait runs under the watchdog, since a kernel that never ends hangs
there, and so do the launches: an eager chunk's ~15,000 fill the CUDA launch
queue behind a stuck kernel, and the host then blocks in the launch. A
replayed chunk's record is marked ``graphed``. The interval
the gauges divide by is the pool's dispatch cadence:
from this chunk's dispatch to the next one's, already made when a younger
chunk is in flight (host-bound, the host's issue of a chunk; card-bound,
the worker dispatches after each fetch, so the card's time a chunk), else
the chunk's own dispatch-to-fetch span. Each record marks the host's
phases (``introspect.PHASES``): its issue ends when the launches and the
copy's start return, its wait is the worker's wait on the copy, and its
finish runs from the copy's arrival through the pool lock and the delivery
to the riders. (The JAX pool divides by the time
between deliveries, floored at the span over the pipeline depth; the chunks
left in flight when the last row finishes are fetched back to back, and
read up to depth x the rate: on the card, MBU 0.49 against 0.13 at one
stream.) A dying worker closes every record it had in flight as
``error``.

Deadlines and cancellation (``deadline.py``): a request carries the
deadline and the journal entry current at submit. ``admit_deadline`` (at
submit, and called by the runner before a pooled request's prefill)
refuses a request whose remaining budget cannot cover one chunk at the
observed cadence (an EMA of the dispatch cadence) while rows are decoding:
a 504 ``DeadlineExceeded`` (stage ``admission``, reject reason
``deadline``), never a solo fallback. At each chunk boundary a row past its
deadline finishes (the ``DEADLINE`` marker before ``DONE``; stage
``decode``, cause ``deadline``) and a cancelled row (its stop event set by
the client's abort) finishes too, each freeing its slot and its KV
reservation at once. A dying pool stamps the cause on every active row's
journal entry. ``close(timeout, strict=False)`` bounds the join for a
recovery teardown, whose worker may be parked on a wedged wait.

``GOFR_POOL_DEBUG=1`` (read at import, as in the JAX pool) prints one
stderr line a fetched chunk that has a dispatch record, in the JAX pool's
format: ``[pool] chunk active=<riders> dispatch->fetch <ms> fetch-wait
<ms> deliver <ms>``: from the record's marks, the chunk's dispatch to the
end of its host copy, the worker's wait on that copy, and the delivery to
the riders; `` graphed`` ends the line of a replayed chunk.

Counters (``occupancy()``): ``graph_chunks`` (replays), ``eager_chunks``
(chunks run eagerly, by ``chunk_path``'s reason), ``graph_capture_s`` and
``graph_pool_bytes`` (the captured graphs' private memory). A replay adds
the kernel launches its capture recorded to ``ops/flash.py``'s counters,
so they count what the card ran.
"""

from __future__ import annotations

import contextlib
import queue
import sys
import threading
import time
from collections import deque
from typing import Any, Optional

import numpy as np
import torch

from gofr_tpu_torch.config import env_flag
from gofr_tpu_torch.deadline import (
    cancellations_counter,
    clamp_spec_k,
    current_deadline,
    deadline_exceeded_counter,
    pool_reject_counter,
)
from gofr_tpu_torch.errors import DeadlineExceeded
from gofr_tpu_torch.ops import flash
from gofr_tpu_torch.ops.attention import kv_bits
from gofr_tpu_torch.telemetry import current_journal_entry, current_record
from gofr_tpu_torch.tpu.batcher import verify_width, verify_width_ladder
from gofr_tpu_torch.tpu.flops import mbu, mfu, tree_bytes
from gofr_tpu_torch.tpu.introspect import host_wait
from gofr_tpu_torch.tpu.kv_blocks import to_device

DONE = object()  # end-of-stream marker on a slot's token queue
# precedes DONE when the row's deadline expired mid-decode: the consumer
# raises DeadlineExceeded instead of ending the stream cleanly
DEADLINE = object()

# chunks in flight (DECODE_PIPELINE): the fetch of chunk N overlaps the
# younger chunks' execution
PIPELINE_DEPTH = 3
# GOFR_POOL_DEBUG=1: one stderr line a chunk (dispatch, fetch and deliver
# ms): the first tool when pooled tok/s parts from the chunk's own rate
_POOL_DEBUG = env_flag("GOFR_POOL_DEBUG")
# how long close() waits for the worker: one chunk's launches take the host
# well under a second at llama3-8b
CLOSE_TIMEOUT_S = 60
PENALTY_MODES = ("lazy", "eager", "off")  # DECODE_POOL_PENALTIES
# dry spec rounds (no row drafted) before an armed cohort gets its full
# pipeline back
SPEC_IDLE_ROUNDS = 4


def chunk_path(adapter: bool, penalized: bool, all_greedy: bool, sharded: bool,
               device_type: str, captured: Any) -> str:
    """How a pool chunk runs, from what the pool observes: "graph" (a
    replay of the captured plain chunk for this ``all_greedy``) or why it
    runs eagerly: "adapter", "penalized", "sharded", "cpu", or
    "uncaptured" (no graph for it: the construction's own chunk, before
    the capture). ``captured``: the ``all_greedy`` values whose plain
    chunk was captured."""
    if adapter:
        return "adapter"
    if penalized:
        return "penalized"
    if sharded:
        return "sharded"
    if device_type != "cuda":
        return "cpu"
    return "graph" if all_greedy in captured else "uncaptured"


class ChunkGraph:
    """The pool's plain chunk captured once into a CUDA graph (on its own
    private memory pool), replayed in place of its launches. ``run``
    computes the chunk on the pool's fixed tensors and returns its output
    buffers, which every replay overwrites. A ``generator`` the chunk
    draws from is registered with the graph: each replay advances it as
    the eager chunk would. Capture launches nothing, so the kernel launch
    counters are put back after it, and each replay adds what the capture
    recorded."""

    def __init__(self, run: Any, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        counters = flash.launch_counters()
        before = {name: c.value for name, c in counters.items()}
        torch.cuda.synchronize(device)
        # the capture empties the allocator's cache first: what it then
        # reserves is the graph's private pool
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        start = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        # thread_local: another thread's CUDA call (the device's probe) must
        # not break the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.outputs = run()
        self.capture_s = time.perf_counter() - start
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.launches = {}
        for name, c in counters.items():
            n = c.value - before[name]
            if n:
                c.add(-n)
                self.launches[c] = n

    def replay(self) -> tuple:
        self.graph.replay()
        for c, n in self.launches.items():
            c.add(n)
        return self.outputs


class PoolFailure:
    """Pushed to every waiter when the worker dies; carries the cause so
    request threads re-raise instead of silently truncating output."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class HostFetch:
    """Copies of a dispatch's outputs to the host, started right after the
    dispatch. On a card: into pinned buffers with ``non_blocking``, and an
    event recorded right behind the copies; ``wait`` waits on that event
    alone, so work enqueued after it (the next chunk) does not hold it up.
    A graph replay's outputs are the graph's own buffers, which the next
    replay overwrites: the copies are queued on the same stream right
    behind the replay, before the next one, so they read this chunk's
    values. On the CPU the values are already there."""

    def __init__(self, *tensors: torch.Tensor):
        self._event = None
        if tensors and tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
            for host, t in zip(self._host, tensors):
                host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = list(tensors)

    def wait(self) -> list[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [t.numpy() for t in self._host]


class _Request:
    """Host-side bookkeeping for one pooled generation. Lives in dispatch
    snapshots; a slot's ``request`` moves on to the next request while old
    snapshots still reference this one (``finished`` gates delivery)."""

    __slots__ = (
        "out_queue", "remaining", "cache_len", "stop", "stop_tokens", "finished",
        "want_lp", "want_top", "want_kv", "kv_reserved", "spec", "pending", "record",
        "journal", "deadline",
    )

    def __init__(self, out_queue: "queue.Queue", remaining: int, cache_len: int,
                 stop: Optional[threading.Event], stop_tokens: frozenset,
                 want_lp: bool = False, want_top: bool = False, want_kv: bool = False,
                 kv_reserved: int = 0, spec: Any = None, pending: int = 0,
                 record: Any = None, journal: Any = None, deadline: Any = None):
        self.out_queue: Optional[queue.Queue] = out_queue
        self.remaining = remaining
        self.cache_len = cache_len
        self.stop = stop
        self.stop_tokens = stop_tokens
        self.finished = False
        # bursts become (token, logprob, tops | None) triples; the logprobs
        # ride every chunk, these flags pick the delivery shape and gate
        # the top-k copy
        self.want_lp = want_lp
        self.want_top = want_top
        # hand the slot's KV row back at finish (("kv", row) precedes DONE)
        # for the prefix cache's conversation store
        self.want_kv = want_kv
        # paged-KV ledger reservation (blocks), released the moment the
        # request finishes
        self.kv_reserved = kv_reserved
        # pooled speculation: the request's SpecRequestState, None when it
        # is not armed (sampled, penalized, logprobs, or SPEC_POOLED off)
        self.spec = spec
        # the feed-forward token, tracked on the host for armed requests
        # (first_token, then the last delivered token): a spec cycle
        # rebuilds the device token row from these
        self.pending = int(pending)
        # the request's flight record: the chunks it rides note their ids
        self.record = record
        # its journal entry (a dying pool stamps the interruption's cause)
        # and its end-to-end deadline (checked at every chunk boundary)
        self.journal = journal
        self.deadline = deadline


class _Slot:
    __slots__ = ("index", "request")

    def __init__(self, index: int):
        self.index = index
        self.request: Optional[_Request] = None


class DecodePool:
    """``n_slots`` rows of KV cache (in ``cache_dtype``, default the
    model's) decoded together, ``chunk`` steps per dispatch. ``scheduler``
    (``tpu/scheduler.py``) is told of every chunk and verify; ``kv`` (a
    ``BlockPool``) gates admission on its ledger; ``penalties`` is
    DECODE_POOL_PENALTIES; ``spec`` (a ``PoolSpecConfig``) turns pooled
    speculation on; ``metrics`` (a ``Registry``) takes the pool's families,
    labelled ``model``; ``timeline`` and ``watchdog`` observe its dispatches;
    ``n_params``, ``peak_flops`` and ``peak_hbm_bw`` feed the MFU and MBU
    gauges (registered when given)."""

    def __init__(
        self,
        model: Any,
        n_slots: int,
        chunk: int,
        pipeline_depth: int = PIPELINE_DEPTH,
        scheduler: Any = None,
        kv: Any = None,
        penalties: str = "lazy",
        cache_dtype: Optional[torch.dtype] = None,
        spec: Any = None,
        metrics: Any = None,
        model_name: str = "",
        timeline: Any = None,
        watchdog: Any = None,
        n_params: int = 0,
        peak_flops: float = 0.0,
        peak_hbm_bw: float = 0.0,
    ):
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if penalties not in PENALTY_MODES:
            raise ValueError(f"penalties must be lazy|eager|off, got {penalties!r}")
        self.model = model
        self.cfg = model.cfg
        self.n_slots = n_slots
        self.chunk = chunk
        self.pipeline_depth = pipeline_depth
        self.max_len = model.cfg.max_seq
        self._sched = scheduler
        self._kv = kv
        dev = model.device
        # under a serving mesh (a ShardedTransformer) the slot cache shards
        # as the model's caches do: slots over the dp x fsdp row groups, KV
        # heads over tp, each shard on its device; the per-slot sampling
        # state stays on the mesh's first device, where the logits gather
        self.mesh_axes = getattr(model, "mesh_axes", None)
        self.cache = model.init_cache(n_slots, self.max_len, cache_dtype)
        self._last_tokens = torch.zeros((n_slots, 1), dtype=torch.int32, device=dev)
        # per-slot sampling knobs: host copies (the all-greedy test and
        # change detection) and device vectors, written per slot in place
        self._temps = np.zeros(n_slots, np.float32)
        self._top_ks = np.zeros(n_slots, np.int32)
        self._top_ps = np.ones(n_slots, np.float32)
        self._min_ps = np.zeros(n_slots, np.float32)
        self._temps_dev = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        self._top_ks_dev = torch.zeros(n_slots, dtype=torch.int32, device=dev)
        self._top_ps_dev = torch.ones(n_slots, dtype=torch.float32, device=dev)
        self._min_ps_dev = torch.zeros(n_slots, dtype=torch.float32, device=dev)
        # the JAX pool's key split: one device generator the worker owns
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(np.random.SeedSequence().entropy % (1 << 63)))
        # per-slot penalty state (allocated by _enable_penalties)
        self._pen_mode = penalties
        self._pen_ready = False
        self._pen_wanted = False  # lazy: the worker allocates at its next turn
        self._pen_slots: set[int] = set()
        # pooled multi-LoRA: the bank model, its name -> index map, per-slot
        # ids (host copy, uploaded by the worker when they change), and a
        # bank waiting for the live adapter slots to finish
        self._lora_ready = False
        self._lora_slots: set[int] = set()
        self._lora_index: dict[str, int] = {}
        self._lora_model: Any = None
        self._lora_pending: Optional[tuple] = None
        self._lora_ids = np.zeros(n_slots, np.int64)
        self._lora_dirty = True
        self._lora_ids_dev: Optional[torch.Tensor] = None
        self.lora_chunks = 0  # dispatches through the adapter chunk
        # the plain chunk's CUDA graphs by all_greedy (on a card, one
        # unsharded model), replays of them, and chunks run eagerly by
        # ``chunk_path``'s reason
        self._graphs: dict[bool, ChunkGraph] = {}
        self.graph_chunks = 0
        self.eager_chunks: dict[str, int] = {}
        self._chunk_graphed = False  # whether the last chunk was a replay
        self._chunk_lora: Optional[tuple] = None  # the next chunk's (bank, ids)
        self._slots = [_Slot(i) for i in range(n_slots)]
        self._free = list(reversed(self._slots))
        self._active: dict[int, _Slot] = {}
        self._admissions: list = []  # (slot, row, length, first token, knobs)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._closed = False
        self.dispatches = 0  # chunks dispatched
        self.rejects: dict[str, int] = {}  # submit rejections by reason
        self.spec_cfg = spec
        self._spec_idle = 0  # consecutive spec rounds in which no row drafted
        # verify dispatches, the rows they carried, drafted / accepted /
        # emitted tokens, and verify dispatches by width
        self.spec_stats: dict = {"cycles": 0, "rows": 0, "drafted": 0, "accepted": 0,
                                 "emitted": 0, "widths": {}}
        self._model_name = model_name
        self._depth_gauge = self._reject_counter = self._tokens_counter = None
        self._deadline_counter = self._cancel_counter = None
        if metrics is not None:
            self._depth_gauge = metrics.gauge("gofr_tpu_decode_slots_active",
                                              "active decode slots")
            self._reject_counter = pool_reject_counter(metrics)
            self._deadline_counter = deadline_exceeded_counter(metrics)
            self._cancel_counter = cancellations_counter(metrics)
            # a lookup: the family's registration home is the device's
            self._tokens_counter = metrics.counter("gofr_tpu_tokens_total",
                                                   labels=("model", "op"))
        # the observed chunk cadence (EMA of the dispatch cadence): the unit
        # of "can this request still get one chunk before its deadline"
        self._chunk_ema_s = 0.0
        self._timeline = timeline
        self._watchdog = watchdog
        self._n_params = n_params
        self._peak_flops = peak_flops
        self._peak_bw = peak_hbm_bw
        self._mfu_gauge = self._mbu_gauge = None
        if metrics is not None and n_params and peak_flops:
            self._mfu_gauge = metrics.gauge("gofr_tpu_mfu", labels=("model", "op"))
        # decode streams every weight a step, plus each row's KV: MBU, not
        # MFU, says how close it runs to the memory roofline
        self._weight_bytes = tree_bytes(model)
        itemsize = torch.empty((), dtype=cache_dtype or model.cfg.dtype).element_size()
        self._kv_bytes_per_token = (
            2 * self.cfg.n_layers * self.cfg.n_kv_heads * self.cfg.head_dim * itemsize
        )
        if metrics is not None and peak_hbm_bw:
            self._mbu_gauge = metrics.gauge(
                "gofr_tpu_mbu",
                "HBM bandwidth utilization of the decode loop "
                "(weights+KV bytes per step / time / peak bandwidth)",
                labels=("model", "op"),
            )
        # the record of a dispatch that raised before reaching in_flight
        self._pending_drec: Any = None
        self._in_flight: Optional[deque] = None
        # one chunk now (kernel build, cuBLAS's first products), then back
        # to empty slots: the first request must not pay it under the lock
        with torch.no_grad():
            HostFetch(self._run_executable()[0]).wait()
            if spec is not None:
                self._warm_spec()
        self.cache["lengths"].zero_()
        self._last_tokens.zero_()
        if dev.type == "cuda" and self.mesh_axes is None:
            # before the worker starts: the plain chunk, greedy and sampled
            with torch.no_grad():
                self._graphs[True] = ChunkGraph(lambda: self._plain_chunk(True), dev)
                self._graphs[False] = ChunkGraph(lambda: self._plain_chunk(False), dev,
                                                 self._generator)
        self.dispatches = 0
        self.eager_chunks = {}
        if penalties == "eager":
            self._enable_penalties()
        self._thread = threading.Thread(target=self._run, daemon=True, name="gofr-decode-pool")
        self._thread.start()

    # -- request side --------------------------------------------------------
    def submit(
        self,
        row_cache: dict,
        start_len: int,
        first_token: int,
        max_new: int,
        sampler: Any,
        stop: Optional[threading.Event] = None,
        stop_tokens: frozenset = frozenset(),
        want_logprobs: bool = False,
        want_top_logprobs: bool = False,
        want_kv: bool = False,
        penalty: Optional[tuple] = None,
        spec_ctx: Optional[Any] = None,
        adapter: Optional[str] = None,
    ) -> "queue.Queue":
        """Claim a slot for a prefilled request (``row_cache``: its
        ``[L, 1, S, Hkv, D]`` k/v, valid up to ``start_len``, produced on
        the default stream); returns the queue its decoded bursts (then
        DONE) arrive on. Raises queue.Full when no slot or no KV budget is
        free, or the penalty state is off or not there yet (the caller
        decodes solo), and RuntimeError once the pool is closed. The row
        must stay unchanged until the worker has issued its copy (the next
        dispatch).

        ``penalty`` pools a penalized request: (presence row [1, V] bool,
        counts row [1, V] f32, bias row [1, V] f32, repetition_penalty,
        presence_penalty, frequency_penalty), the rows on the device and
        already counting ``first_token``.

        ``spec_ctx`` (the prompt's ids) arms pooled speculation for the
        request when the pool has a spec config and the request is eligible
        (greedy, unpenalized, base weights, no logprobs: the verify
        computes argmaxes, not logprob rows); other requests pool plainly.

        ``adapter`` pools a LoRA request: its slot decodes with that
        adapter's bank entry while co-tenants keep theirs (or the base).
        The name resolves against the CURRENT bank under the lock; the
        request solos (queue.Full) while the bank is off or rebuilding, the
        name is not in it, or a penalized slot is active."""
        out: "queue.Queue" = queue.Queue()
        deadline = current_deadline()
        spec_state = self._spec_arm(spec_ctx, first_token, sampler, penalty, adapter,
                                    want_logprobs, want_top_logprobs)
        with self._work:
            if self._closed:
                self._reject("closed", count_only=True)
                raise RuntimeError("decode pool closed")
            self._admit_deadline(deadline)
            adapter_idx = self._admit(adapter, penalty)
            if not self._free:
                self._reject("no_free_slots", "no free decode slots")
            kv_reserved = self._reserve_kv(start_len, max_new)
            slot = self._free.pop()
            record = current_record()
            slot.request = _Request(
                out, max_new, start_len, stop, frozenset(stop_tokens or ()),
                want_lp=want_logprobs, want_top=want_top_logprobs, want_kv=want_kv,
                kv_reserved=kv_reserved, spec=spec_state, pending=first_token, record=record,
                journal=current_journal_entry(), deadline=deadline,
            )
            if record is not None and kv_reserved:
                record.note_kv(kv_reserved)
            if spec_state is not None:
                # a fresh context may draft where the cohort's could not:
                # re-open the spec window
                self._spec_idle = 0
            knobs = (sampler.temperature, sampler.top_k, sampler.top_p, sampler.min_p)
            if penalty is not None:
                self._pen_slots.add(slot.index)
            if adapter_idx:
                self._lora_ids[slot.index] = adapter_idx
                self._lora_dirty = True
                self._lora_slots.add(slot.index)
            # the worker issues the slot's writes before its next dispatch
            self._admissions.append(
                (slot.index, row_cache, start_len, first_token, knobs, penalty)
            )
            self._active[slot.index] = slot
            if record is not None:
                # decodes pooled beside len(_active) - 1 co-tenants
                record.mark_pooled(len(self._active))
            if self._depth_gauge is not None:
                self._depth_gauge.set(len(self._active))
            self._work.notify()
        return out

    def admit_deadline(self, deadline: Any) -> None:
        """The deadline gate ahead of a pooled request's prefill (the
        runner calls it): the verdict ``submit`` would give, before the
        prefill burns the card on a request that cannot be served."""
        if deadline is None:
            return
        with self._work:
            self._admit_deadline(deadline)

    def _admit_deadline(self, deadline: Any) -> None:
        """The deadline admission gate (pool lock held): a request whose
        remaining budget cannot cover one chunk at the observed cadence
        cannot finish in time, so it is refused with a 504 (never a solo
        fallback: solo is slower). With no row decoding the cadence is
        stale (one slow chunk would reject everything and nothing would
        decay it), so only a spent budget is refused then."""
        if deadline is None:
            return
        remaining = deadline.remaining()
        if remaining > 0 and (remaining >= self._chunk_ema_s or not self._active):
            return
        self._reject("deadline", count_only=True)
        if self._deadline_counter is not None:
            self._deadline_counter.inc(stage="admission")
        record = current_record()
        if record is not None:
            record.note_shed("admission")
        raise DeadlineExceeded(
            f"remaining deadline budget {max(remaining, 0) * 1000:.0f} ms cannot cover one "
            f"decode chunk (observed cadence {self._chunk_ema_s * 1000:.0f} ms)",
            stage="admission",
        )

    def _write_slot(self, index: int, row: dict, length: int) -> None:
        """Copy a row's first ``length`` positions into slot ``index``."""
        n = int(length)
        with torch.no_grad():
            for name in ("k", "v"):
                kv_bits(self.cache[name])[:, index, :n].copy_(kv_bits(row[name])[:, 0, :n])
            self.cache["lengths"][index].fill_(n)

    def _read_slot(self, index: int) -> dict:
        """A private copy of slot ``index``'s row (the finish-time hand-back
        to the prefix cache)."""
        return {
            "k": self.cache["k"][:, index : index + 1].clone(),
            "v": self.cache["v"][:, index : index + 1].clone(),
            "lengths": self.cache["lengths"][index : index + 1].clone(),
        }

    def _reserve_kv(self, start_len: int, max_new: int) -> int:
        """Reserve the request's whole KV block budget on the shared ledger
        (pool lock held): prompt + first token + every step it may take,
        capped at the cache bound. Exhaustion rejects with ``kv_exhausted``."""
        if self._kv is None:
            return 0
        from gofr_tpu_torch.tpu.kv_blocks import KVExhausted

        try:
            return self._kv.reserve_ledger(min(start_len + 1 + max_new, self.max_len))
        except KVExhausted as exc:
            self._reject("kv_exhausted", f"KV block budget exhausted: {exc}")

    def _admit_pending(self) -> None:
        """Issue the queued admissions' writes (worker thread, pool lock
        held): the slot's KV rows and length, its first token, its
        sampling knobs and its penalty rows and knobs, then the adapter ids
        when they changed. Issued by the thread that dispatches, so each
        lands after every chunk dispatched before it and before the next."""
        if self._pen_wanted and not self._pen_ready:
            self._enable_penalties()
        for index, row, length, first_token, knobs, penalty in self._admissions:
            self._write_slot(index, row, length)
            self._last_tokens[index].fill_(int(first_token))
            self._set_knobs(index, knobs)
            if penalty is not None:
                self._apply_penalty(index, penalty)
        self._admissions.clear()
        if self._lora_dirty and self._lora_slots:
            self._lora_ids_dev = to_device(self._lora_ids.copy(), self._last_tokens.device)
            self._lora_dirty = False

    def _lora_chunk(self) -> Optional[tuple]:
        """(bank model, device ids) for the next chunk while an adapter
        slot is active, else None (pool lock held: the worker reads them
        with the records it dispatches)."""
        if not self._lora_slots:
            return None
        return self._lora_model, self._lora_ids_dev

    # -- pooled multi-LoRA ------------------------------------------------------
    def enable_lora(self, stacked: Any, index: "dict[str, int]") -> None:
        """Install (or replace) the adapter bank: a ``build_lora_stack``
        model and its name -> bank index map. While adapter slots are
        live the swap waits for them (their ids index the OLD bank; new
        adapter submits solo meanwhile), so an admin load never blocks
        behind a long generation."""
        with self._work:
            if self._lora_slots:
                self._lora_ready = False  # stop new submits on the old bank
                self._lora_pending = (stacked, dict(index))
            else:
                self._install_lora(stacked, dict(index))

    def _install_lora(self, stacked: Any, index: "dict[str, int]") -> None:
        """Swap in a bank (pool lock held, no adapter slot active)."""
        self._lora_model = stacked
        self._lora_index = index
        self._lora_ids[:] = 0
        self._lora_dirty = True
        self._lora_pending = None
        self._lora_ready = True

    def disable_lora(self) -> None:
        """Stop pooling adapter requests (they solo). Live adapter slots
        finish on the bank they hold, which stays until the next
        ``enable_lora`` replaces it."""
        with self._work:
            self._lora_ready = False
            self._lora_index = {}
            self._lora_pending = None

    # -- per-slot penalties ----------------------------------------------------
    def _enable_penalties(self) -> None:
        """Allocate the penalty state: [slots, V] presence, counts and bias
        rows (all zero: identity for every slot) and the knob vectors."""
        n, v, dev = self.n_slots, self.cfg.vocab_size, self._last_tokens.device
        with torch.no_grad():
            self._pres = torch.zeros((n, v), dtype=torch.bool, device=dev)
            self._cnts = torch.zeros((n, v), dtype=torch.float32, device=dev)
            self._bias = torch.zeros((n, v), dtype=torch.float32, device=dev)
            self._reps = np.ones(n, np.float32)
            self._pps = np.zeros(n, np.float32)
            self._fps = np.zeros(n, np.float32)
            self._reps_dev = torch.ones(n, dtype=torch.float32, device=dev)
            self._pps_dev = torch.zeros(n, dtype=torch.float32, device=dev)
            self._fps_dev = torch.zeros(n, dtype=torch.float32, device=dev)
        self._pen_ready = True

    def _admit(self, adapter: Optional[str], penalty: Optional[tuple]) -> int:
        """The submit's reject gates (pool lock held), each raising
        queue.Full through ``_reject`` with its reason: one chunk function
        a dispatch, so adapter and penalized slots never mix, and a
        penalized request waits for the penalty state (a lazy pool's first
        one asks the worker to allocate it). Returns the adapter's bank
        index (0 = the base weights)."""
        adapter_idx = 0
        if adapter is not None:
            if penalty is not None:
                self._reject("penalized_adapter", "penalized adapter requests decode solo")
            if not self._lora_ready:
                self._reject("bank_rebuilding", "adapter bank off or rebuilding")
            if self._pen_slots:
                self._reject("penalized_mix", "penalized slots active (one chunk function)")
            idx = self._lora_index.get(adapter)
            if idx is None:
                self._reject("unknown_adapter", f"adapter '{adapter}' not in the pool bank")
            adapter_idx = idx
        if penalty is not None and self._lora_slots:
            self._reject("adapter_mix", "adapter slots active (one chunk function)")
        if penalty is not None and not self._pen_ready:
            if self._pen_mode == "lazy":
                self._pen_wanted = True
                self._work.notify()
            off = self._pen_mode == "off"
            self._reject("penalties_off" if off else "penalties_warming",
                         "penalized pool path " + ("disabled" if off else "warming"))
        return adapter_idx

    def _apply_penalty(self, index: int, penalty: tuple) -> None:
        """Write a penalized request's rows and knobs into its slot (worker
        thread, pool lock held)."""
        pres_row, cnt_row, bias_row, rep, pp, fp = penalty
        with torch.no_grad():
            self._pres[index].copy_(pres_row[0])
            self._cnts[index].copy_(cnt_row[0])
            self._bias[index].copy_(bias_row[0])
        self._set_pen_knobs(index, (rep, pp, fp))

    def _set_pen_knobs(self, index: int, knobs: tuple) -> None:
        pairs = zip((self._reps, self._pps, self._fps),
                    (self._reps_dev, self._pps_dev, self._fps_dev), knobs)
        for host, dev, value in pairs:
            if host[index] != value:
                host[index] = value
                dev[index].fill_(value)

    def _set_knobs(self, index: int, knobs: tuple) -> None:
        """A slot's sampling knobs, written on the card only where they
        changed (worker thread)."""
        pairs = zip((self._temps, self._top_ks, self._top_ps, self._min_ps),
                    (self._temps_dev, self._top_ks_dev, self._top_ps_dev, self._min_ps_dev),
                    knobs)
        for host, dev, value in pairs:
            if host[index] != value:
                host[index] = value
                dev[index].fill_(value)

    def _reject(self, reason: str, msg: str = "", count_only: bool = False) -> None:
        """Count a submit rejection and raise ``queue.Full`` unless
        ``count_only``: the device then decodes the request solo."""
        self.rejects[reason] = self.rejects.get(reason, 0) + 1
        if self._reject_counter is not None:
            self._reject_counter.inc(reason=reason)
        record = current_record()
        if record is not None:
            record.note_pool_reject(reason)
        if not count_only:
            raise queue.Full(msg)

    # -- worker --------------------------------------------------------------
    def _run(self) -> None:
        try:
            with torch.no_grad():
                self._loop()
        except BaseException as exc:  # device errors must not hang waiters
            self._abandon_in_flight()
            with self._work:
                self._closed = True
                self._fail_active(exc)

    def _abandon_in_flight(self) -> None:
        """The worker died or the pool closed: close every dispatch record
        it still had in flight as ``error`` (a phantom "running" chunk would misdirect the
        diagnosis the timeline exists for)."""
        if self._timeline is None:
            return
        if self._pending_drec is not None:
            self._timeline.finish(self._pending_drec, status="error")
            self._pending_drec = None
        for entry in list(self._in_flight or ()):
            if entry[3] is not None:
                self._timeline.finish(entry[3], status="error")

    def _fail_active(self, exc: BaseException) -> None:
        for slot in self._active.values():
            req = slot.request
            if req is not None and not req.finished and req.out_queue is not None:
                if req.journal is not None:
                    # the cause, stamped before the waiter re-raises: the
                    # entry is what a resume claims back
                    req.journal.note_interrupted(
                        f"decode pool failed: {type(exc).__name__}: {exc}"
                    )
                req.out_queue.put(PoolFailure(exc))
                req.out_queue.put(DONE)
                req.finished = True
            if req is not None and req.kv_reserved:
                # a dead pool must not pin KV budget against the prefix cache
                self._kv.release_ledger(req.kv_reserved)
                req.kv_reserved = 0
            slot.request = None
        self._active.clear()
        self._admissions.clear()
        self._pen_slots.clear()
        self._lora_slots.clear()
        self._lora_ids[:] = 0
        self._lora_dirty = True
        if self._lora_pending:
            self._install_lora(*self._lora_pending)
        self._free = list(reversed(self._slots))
        if self._sched is not None:
            self._sched.note_decode_idle()  # a dead pool must not gate prefill

    def _loop(self) -> None:
        # (records, fetch, want_top, dispatch record, dispatch start, bytes)
        in_flight: deque = deque()
        self._in_flight = in_flight
        while True:
            with self._work:
                while (not self._active and not in_flight and not self._closed
                       and not (self._pen_wanted and not self._pen_ready)):
                    self._work.wait()
                if self._closed:
                    # closing mid-stream is an ERROR for waiters, never a
                    # silently truncated "ok"; the chunks still in flight
                    # are never fetched, so their records close as errors
                    # (no phantom "running" dispatch after a close)
                    self._abandon_in_flight()
                    self._fail_active(RuntimeError("decode pool closed mid-generation"))
                    return
                self._admit_pending()
                records = plan = None
                # spec cycles run at depth 1 (the host reads a verify to
                # roll back before the next dispatch), never beside chunks
                # in flight
                spec_armed = self._spec_ready()
                if not in_flight and spec_armed:
                    plan = self._spec_plan()
                    self._spec_idle = 0 if plan is not None else self._spec_idle + 1
                # an armed, productive cohort keeps the depth at 1 (a full
                # pipeline never drains while rows stay active, so the spec
                # window would never re-open); one whose drafts keep missing
                # gets the pipeline back after a few dry rounds
                depth = (1 if spec_armed and self._spec_idle < SPEC_IDLE_ROUNDS
                         or self._chunk_path(bool(self._lora_slots))[0] == "graph"
                         else self.pipeline_depth)
                if plan is None and self._active and len(in_flight) < depth:
                    records = [(slot.index, slot.request) for slot in self._active.values()]
                    self._chunk_lora = self._lora_chunk()
            # outside the lock: a dispatch's launches take the host far
            # longer than a submit or a delivery, which must not wait; the
            # pipeline fills before the oldest chunk is fetched
            if plan is not None:
                self._spec_cycle(plan)
            elif records is not None:
                self._dispatch_chunk(in_flight, records)
            elif in_flight:
                self._fetch_and_deliver(in_flight)

    def _dispatch_chunk(self, in_flight: deque, records: Optional[list] = None) -> None:
        """Dispatch ONE pipelined chunk for ``records`` (by default the
        active slots, read with the pool lock held by the caller) and start
        its copy to the host. Only the worker calls it while the pool
        serves: it alone issues the pool's CUDA work."""
        if records is None:
            records = [(slot.index, slot.request) for slot in self._active.values()]
            self._chunk_lora = self._lora_chunk()
        drec = self._begin_record("decode_chunk", records,
                                  adapter=self._chunk_lora is not None)
        # what the chunk streams: the weights each step, and each active
        # row's KV up to its length that step (host-tracked lengths)
        kv_positions = sum(
            self.chunk * min(req.cache_len, self.max_len) + self.chunk * (self.chunk - 1) // 2
            for _, req in records if req is not None and not req.finished
        )
        nbytes = self.chunk * self._weight_bytes + kv_positions * self._kv_bytes_per_token
        start = time.perf_counter()
        # the launches run under the watchdog too: a card that stops
        # draining its queue fills the CUDA launch queue, and the host then
        # blocks here, in the launch, long before it waits on the copy
        with self._watch("decode_chunk", drec):
            toks, lps, tvals, tids = self._run_executable()
            want_top = any(req is not None and req.want_top for _, req in records)
            fetch = HostFetch(toks, lps, *((tvals, tids) if want_top else ()))
        if drec is not None:
            drec.mark_issued()
            drec.graphed = self._chunk_graphed
        in_flight.append((records, fetch, want_top, drec, start, nbytes))
        self._pending_drec = None  # owned by in_flight now
        self.dispatches += 1
        if self._sched is not None:
            # decode keeps its cadence; prefill takes the gaps between notes
            self._sched.note_decode_chunk(len(records))

    def _run_executable(self) -> tuple:
        """ONE chunk over every slot; the feed-forward token and the cache
        stay on the card. The adapter chunk runs while an adapter slot is
        active (``_chunk_lora``: the bank model and the slots' ids, read
        under the lock with the chunk's records), the penalized chunk while a
        penalized slot is (never both: ``_admit`` keeps them apart);
        plain traffic keeps the plain one, replayed from its graph where
        ``chunk_path`` says so. (Only the worker empties ``_pen_slots``; a
        submit adding to it between the snapshot and here is harmless: its
        slot is not in this chunk's records, and a plain slot samples alike
        under either chunk.)"""
        path, all_greedy = self._chunk_path(self._chunk_lora is not None)
        self._chunk_graphed = path == "graph"
        if self._chunk_graphed:
            self.graph_chunks += 1
            return self._graphs[all_greedy].replay()
        self.eager_chunks[path] = self.eager_chunks.get(path, 0) + 1
        if self._chunk_lora is None and not self._pen_slots:
            return self._plain_chunk(all_greedy)
        knobs = (self._temps_dev, self._top_ks_dev, self._top_ps_dev, self._min_ps_dev)
        if self._chunk_lora is not None:
            bank, ids = self._chunk_lora
            self.lora_chunks += 1
            (toks, lps, tvals, tids, token, cache) = bank.decode_chunk_pool_lora(
                ids, self._last_tokens, self.cache, self.chunk, self._generator, *knobs,
                all_greedy=all_greedy,
            )
        else:
            (toks, lps, tvals, tids, token, cache, self._pres,
             self._cnts) = self.model.decode_chunk_pool_penalized(
                self._last_tokens, self.cache, self.chunk, self._generator, *knobs,
                self._pres, self._reps_dev, self._cnts, self._pps_dev, self._fps_dev,
                self._bias, all_greedy=all_greedy,
            )
        self._commit(cache["lengths"], token)
        return toks, lps, tvals, tids

    def _chunk_path(self, adapter: bool) -> tuple[str, bool]:
        """(``chunk_path``'s verdict, all_greedy) for a chunk over the slots
        as they are now, with or without an adapter slot."""
        all_greedy = bool((self._temps <= 0.0).all())
        return chunk_path(adapter, bool(self._pen_slots), all_greedy, self.mesh_axes is not None,
                          self._last_tokens.device.type, self._graphs), all_greedy

    def _plain_chunk(self, all_greedy: bool) -> tuple:
        """The plain chunk over the pool's fixed tensors, eager or under a
        graph's capture: the same computation either way."""
        knobs = (self._temps_dev, self._top_ks_dev, self._top_ps_dev, self._min_ps_dev)
        (toks, lps, tvals, tids, token, cache) = self.model.decode_chunk_pool(
            self._last_tokens, self.cache, self.chunk, self._generator, *knobs,
            all_greedy=all_greedy,
        )
        self._commit(cache["lengths"], token)
        return toks, lps, tvals, tids

    def _commit(self, lengths: torch.Tensor, token: Optional[torch.Tensor] = None) -> None:
        """A dispatch's advanced lengths and feed-forward token, written
        into the pool's own tensors in place: a captured graph holds their
        addresses, so no path rebinds them."""
        self.cache["lengths"].copy_(lengths)
        if token is not None:
            self._last_tokens.copy_(token)

    def _begin_record(self, kind: str, records: list, tokens: int = 0,
                      adapter: bool = False) -> Any:
        """A dispatch's timeline record (None without a timeline), running
        from now; every riding request's flight record learns its id.
        ``adapter``: the chunk runs through the adapter bank (its cost
        sheet is the adapter path's)."""
        if self._timeline is None:
            return None
        drec = self._timeline.begin(kind, batch_size=len(records), tokens=tokens,
                                    adapter=adapter)
        drec.mark_running()
        for _, req in records:
            if req is not None and req.record is not None:
                req.record.note_dispatch_id(drec.dispatch_id)
        # a raise before the dispatch is in flight must not leave it running
        self._pending_drec = drec
        return drec

    def _watch(self, kind: str, drec: Any) -> Any:
        if self._watchdog is None:
            return contextlib.nullcontext()
        return self._watchdog.watch(kind, drec.dispatch_id if drec is not None else 0)

    def _finish_record(self, drec: Any, records: list, status: str = "ok") -> None:
        if drec is None:
            return
        self._timeline.finish(drec, status=status)
        if drec.anomaly:
            # the cost model flagged it at finish: pin it on every rider
            for _, req in records:
                if req is not None and req.record is not None:
                    req.record.note_anomaly(drec.dispatch_id)

    def _fetch_and_deliver(self, in_flight: deque) -> None:
        """Wait for the OLDEST chunk's copy outside the lock (the card runs
        the younger chunks meanwhile, and submits can take the lock to join
        the next dispatch), under the watchdog, then deliver its tokens."""
        records, fetch, want_top, drec, start, nbytes = in_flight.popleft()
        try:
            with self._watch("decode_chunk", drec), host_wait(drec):
                arrays = fetch.wait()
            # the dispatch cadence: to the younger chunk's dispatch, else
            # this chunk's own span
            elapsed = (in_flight[0][4] if in_flight else time.perf_counter()) - start
            tvals, tids = (arrays[2], arrays[3]) if want_top else (None, None)
            with self._work:
                self._deliver(records, arrays[0], arrays[1], tvals, tids, elapsed, drec,
                              nbytes)
        except BaseException:
            self._finish_record(drec, records, status="error")
            raise
        self._finish_record(drec, records)
        if _POOL_DEBUG and drec is not None:
            print(f"[pool] chunk active={len(records)} "
                  f"dispatch->fetch {(drec.t_synced - drec.t_running) * 1e3:.0f}ms "
                  f"fetch-wait {(drec.t_synced - drec.t_wait) * 1e3:.0f}ms "
                  f"deliver {(drec.t_done - drec.t_synced) * 1e3:.0f}ms"
                  + (" graphed" if drec.graphed else ""),
                  file=sys.stderr, flush=True)

    def _deliver(self, records: list, toks: np.ndarray, lps: np.ndarray,
                 tvals: Any, tids: Any, elapsed: float = 0.0, drec: Any = None,
                 nbytes: float = 0.0) -> None:
        self._note_cadence(elapsed)
        delivered = 0
        for index, req in records:
            if req is None or req.finished:
                continue  # freed mid-pipeline; this chunk's row is garbage
            delivered += self._deliver_one(index, req, toks, lps, tvals, tids)
        if self._sched is not None and not self._active:
            self._sched.note_decode_idle()  # release any waiting prefill
        self._account_chunk(delivered, elapsed, drec, nbytes)

    def _note_cadence(self, elapsed: float) -> None:
        """One chunk's or verify's cadence into the EMA (pool lock held)."""
        if elapsed > 0:
            self._chunk_ema_s = (elapsed if self._chunk_ema_s <= 0
                                 else 0.8 * self._chunk_ema_s + 0.2 * elapsed)

    def _account_chunk(self, delivered: int, elapsed: float = 0.0, drec: Any = None,
                       nbytes: float = 0.0) -> None:
        """One chunk's or verify's metrics (pool lock held): the active
        slots, the tokens its requests received, and over ``elapsed`` the
        MFU of the useful tokens and the MBU of the ``nbytes`` it streamed,
        onto the gauges and the dispatch record: host values alone."""
        if self._depth_gauge is not None:
            self._depth_gauge.set(len(self._active))
        if self._tokens_counter is not None and delivered:
            self._tokens_counter.inc(delivered, model=self._model_name, op="decode")
        if drec is not None:
            drec.tokens = delivered
        if self._mfu_gauge is not None and delivered and elapsed > 0:
            value = mfu(self._n_params, delivered, elapsed, self._peak_flops)
            self._mfu_gauge.set(value, model=self._model_name, op="decode")
            if drec is not None:
                drec.mfu = value
        if self._mbu_gauge is not None and nbytes and elapsed > 0:
            value = mbu(nbytes, elapsed, self._peak_bw)
            self._mbu_gauge.set(value, model=self._model_name, op="decode")
            if drec is not None:
                drec.mbu = value

    def _deliver_one(self, index: int, req: _Request, toks: np.ndarray, lps: np.ndarray,
                     tvals: Any, tids: Any) -> int:
        """One request's share of a fetched chunk (pool lock held): one
        burst put, bookkeeping, and the finish when it was cancelled, hit a
        stop token, or ran out of budget or cache. Returns the tokens the
        request received."""
        room = self.max_len - req.cache_len  # valid steps this chunk
        req.cache_len += self.chunk
        take = min(self.chunk, req.remaining, max(room, 0))
        cancelled, expired = self._cut(req)
        hit_stop_token = False
        delivered = 0
        if not cancelled and not expired and req.out_queue is not None:
            burst, hit_stop_token = self._build_burst(
                req, index, toks[index], lps[index], tvals, tids, take
            )
            if burst:
                req.out_queue.put(burst)
                delivered = len(burst)
            if req.spec is not None:
                # an armed row rode a plain chunk (a mixed cohort or a dry
                # spec round): keep its draft context and pending token on
                # the real stream. A continuing row took the whole chunk
                # (shorter takes finish below), so its last token is the
                # device's feed-forward token
                req.spec.note_plain(burst)
                req.pending = req.spec.pending
                if req.record is not None:
                    # a plain chunk streams the weights once a step: its
                    # tokens count at ~1 a stream in tokens_per_dispatch
                    req.record.note_spec(0, 0, delivered, dispatches=self.chunk)
        req.remaining -= take
        if (cancelled or expired or hit_stop_token or req.remaining <= 0
                or req.cache_len >= self.max_len):
            self._finish_request(index, req, cancelled, expired)
        return delivered

    def _cut(self, req: _Request) -> tuple[bool, bool]:
        """(cancelled, expired) for a row at a chunk boundary (pool lock
        held): the client's stop event, else the row's deadline. An expired
        row is counted here (stage ``decode``, cause ``deadline``) and its
        journal entry and flight record learn why."""
        if req.stop is not None and req.stop.is_set():
            return True, False
        if req.deadline is None or not req.deadline.expired():
            return False, False
        if self._deadline_counter is not None:
            self._deadline_counter.inc(stage="decode")
        if self._cancel_counter is not None:
            self._cancel_counter.inc(cause="deadline")
        if req.record is not None:
            req.record.note_shed("decode")
        if req.journal is not None:
            req.journal.note_interrupted("deadline exceeded mid-decode")
        return False, True

    def _build_burst(self, req: _Request, index: int, emitted: Any, emitted_lps: Any,
                     tvals: Any, tids: Any, take: int) -> tuple:
        """ONE queue put per chunk (a burst list), not one per token.
        Returns (burst, hit_stop_token); a stop token ends the stream and is
        not emitted."""
        burst: list = []
        for j, t in enumerate(emitted[:take]):
            if int(t) in req.stop_tokens:
                return burst, True
            if req.want_lp:
                tops = None
                if req.want_top:
                    tops = [(int(tids[index, j, m]), float(tvals[index, j, m]))
                            for m in range(tids.shape[-1])]
                burst.append((int(t), float(emitted_lps[j]), tops))
            else:
                burst.append(int(t))
        return burst, False

    def _finish_request(self, index: int, req: _Request, cancelled: bool,
                        expired: bool = False) -> None:
        """Terminal delivery (pool lock held): the optional KV hand-back,
        DONE (after ``DEADLINE`` for an expired row), the ledger release,
        and (unless the slot was already reused) freeing the slot with its
        knobs reset."""
        req.finished = True
        if (req.want_kv and not cancelled and not expired and req.out_queue is not None
                and self._slots[index].request is req):
            # issued under the lock: the copy is ordered before any later
            # dispatch or slot write reuses the row (lockstep decode only
            # appends past the request's length; the device rolls it back)
            req.out_queue.put(("kv", self._read_slot(index)))
        if req.out_queue is not None:
            if expired:
                req.out_queue.put(DEADLINE)
            req.out_queue.put(DONE)
        req.out_queue = None
        req.stop = None
        if req.kv_reserved:
            # the budget is back on the ledger before this delivery returns
            self._kv.release_ledger(req.kv_reserved)
            req.kv_reserved = 0
        slot = self._slots[index]
        if slot.request is req:  # not already reused
            slot.request = None
            del self._active[index]
            self._free.append(slot)
            self._reset_slot(index)

    def _reset_slot(self, index: int) -> None:
        """Greedy knobs and a zero length on a freed slot (worker thread): a
        past sampled request must not keep the all-greedy fast path (no
        sort) off for every later chunk, nor an idle row read its old
        request's whole cache every step.
        A penalized slot gets identity penalty knobs and a zero bias row:
        a plain request reusing it under the penalized chunk samples as
        under the plain one (presence and counts need no reset: identity
        knobs ignore them; the bias is added unconditionally)."""
        self._set_knobs(index, (0.0, 0, 1.0, 0.0))
        with torch.no_grad():
            # issued after every chunk dispatched so far: the idle row's
            # attention then reads only what it writes from now on
            self.cache["lengths"][index].zero_()
        if index in self._lora_slots:
            # the freed slot stops selecting the adapter: a plain request
            # reusing it under the adapter chunk gathers entry 0 (zero delta)
            self._lora_slots.discard(index)
            self._lora_ids[index] = 0
            self._lora_dirty = True
            if self._lora_pending and not self._lora_slots:
                self._install_lora(*self._lora_pending)  # a rebuild waited for these slots
        if index in self._pen_slots:
            self._pen_slots.discard(index)
            self._set_pen_knobs(index, (1.0, 0.0, 0.0))
            with torch.no_grad():
                self._bias[index].zero_()

    # -- pooled speculation ------------------------------------------------------
    def _warm_spec(self) -> None:
        """One verify at every width of the ladder (constructor): a spec
        cycle's first products must not wait for their set-up. The caller
        zeroes the lengths after."""
        for w in verify_width_ladder(self.spec_cfg.k_max):
            tokens = torch.zeros((self.n_slots, w), dtype=torch.int32,
                                 device=self._last_tokens.device)
            ids, cache = self.model.verify_chunk(tokens, self.cache)
            self._commit(cache["lengths"])
            HostFetch(ids).wait()

    def _spec_arm(self, spec_ctx: Any, first_token: int, sampler: Any, penalty: Any,
                  adapter: Any, want_logprobs: bool, want_top_logprobs: bool) -> Any:
        """A request's draft state when pooled speculation is on and the
        request is eligible (greedy, unpenalized, base weights, no
        logprobs), else None. Called outside the pool lock (it copies the
        prompt into the draft context)."""
        if (self.spec_cfg is None or spec_ctx is None or penalty is not None
                or adapter is not None or want_logprobs or want_top_logprobs
                or not getattr(sampler, "greedy", False)):
            return None
        if not self._free:
            # overload fast-out, read without the lock: the submit is about
            # to reject, so skip the context copy. If a slot frees meanwhile
            # the request pools unarmed (plain decode: the same ids)
            return None
        return self.spec_cfg.new_state([int(t) for t in spec_ctx], first_token)

    def _spec_ready(self) -> bool:
        """Spec cycles run only while EVERY active row is armed and no
        penalized or adapter slot is active (pool lock held): a sampled,
        penalized or adapter co-tenant needs another chunk, so a mixed
        cohort decodes plain."""
        if self.spec_cfg is None or not self._active or self._pen_slots or self._lora_slots:
            return False
        return all(slot.request is not None and slot.request.spec is not None
                   for slot in self._active.values())

    def _spec_plan(self) -> Optional[tuple]:
        """Draft every active row (pool lock held): up to its adaptive k
        tokens under the serving clamps, and no more than its budget and
        cache row leave room for with the bonus. -> (records, drafts by
        slot, the [n_slots, width] host token rows, width), or None when no
        row drafted (the plain chunk is better then: more steps a
        dispatch, no rollback)."""
        records = [(slot.index, slot.request) for slot in self._active.values()]
        drafts: dict[int, list] = {}
        max_k = 0
        level = self.spec_cfg.level()
        for index, req in records:
            k = clamp_spec_k(req.spec.adaptive.current(), level, req.deadline,
                             self._chunk_ema_s)
            k = min(k, req.remaining - 1, self.max_len - req.cache_len - 1)
            drafts[index] = req.spec.propose(k) if k > 0 else []
            max_k = max(max_k, len(drafts[index]))
        if max_k == 0:
            return None
        width = verify_width(max_k, self.spec_cfg.k_max)
        tokens = np.zeros((self.n_slots, width), np.int32)
        for index, req in records:
            tokens[index, 0] = req.pending
            row = drafts[index]
            tokens[index, 1 : 1 + len(row)] = row
        return records, drafts, tokens, width

    def _spec_cycle(self, plan: tuple) -> None:
        """Dispatch one batched verify (worker thread, outside the lock:
        its launches are a chunk's), wait for its argmaxes, then deliver
        and roll back under the lock."""
        records, drafts, tokens, width = plan
        drec = self._begin_record("spec_verify", records, tokens=width)
        kv_positions = sum(width * req.cache_len + width * (width - 1) // 2
                           for _, req in records if req is not None)
        nbytes = self._weight_bytes + kv_positions * self._kv_bytes_per_token
        start = time.perf_counter()
        try:
            with self._watch("spec_verify", drec):  # a full launch queue blocks here
                next_ids, cache = self.model.verify_chunk(
                    to_device(tokens, self._last_tokens.device), self.cache
                )
                self._commit(cache["lengths"])
                fetch = HostFetch(next_ids)
            if drec is not None:
                drec.mark_issued()
            self._pending_drec = None
            if self._sched is not None:
                self._sched.note_decode_chunk(len(records))
            with self._watch("spec_verify", drec), host_wait(drec):
                ids = fetch.wait()[0]
            elapsed = time.perf_counter() - start  # depth 1: the cycle
            with self._work:
                self._spec_deliver(records, drafts, ids, width, elapsed, drec, nbytes)
        except BaseException:
            self._pending_drec = None
            self._finish_record(drec, records, status="error")
            raise
        self._finish_record(drec, records)

    def _spec_deliver(self, records: list, drafts: dict, next_ids: np.ndarray,
                      width: int, elapsed: float = 0.0, drec: Any = None,
                      nbytes: float = 0.0) -> None:
        """Acceptance and rollback of one fetched verify (pool lock held):
        per row, the longest draft prefix matching the target's argmaxes
        commits, plus the bonus token (the target's own continuation, so
        output never depends on the drafts); then every row's committed
        length goes back into the cache lengths in one copy (the rejected
        tail's KV is masked by attention and overwritten by later steps)
        and the device token row is rebuilt from the pending tokens, so the
        next dispatch, spec or plain, feeds forward correctly."""
        self._note_cadence(elapsed)
        stats = self.spec_stats
        stats["cycles"] += 1
        stats["widths"][width] = stats["widths"].get(width, 0) + 1
        delivered = drafted = accepted = 0
        for index, req in records:
            if req is None or req.finished:
                continue
            d = drafts[index]
            row = next_ids[index]
            n_acc = 0
            while n_acc < len(d) and d[n_acc] == int(row[n_acc]):
                n_acc += 1
            stats["rows"] += 1
            drafted += len(d)
            accepted += n_acc
            delivered += self._spec_deliver_one(
                index, req, [int(row[j]) for j in range(n_acc + 1)], n_acc, len(d)
            )
        stats["drafted"] += drafted
        stats["accepted"] += accepted
        stats["emitted"] += delivered
        lengths = np.zeros(self.n_slots, np.int32)
        pendings = np.zeros((self.n_slots, 1), np.int32)
        for index, slot in self._active.items():
            if slot.request is not None:
                lengths[index] = slot.request.cache_len
                pendings[index, 0] = slot.request.pending
        dev = self._last_tokens.device
        self._commit(to_device(lengths, dev), to_device(pendings, dev))
        if self._sched is not None and not self._active:
            self._sched.note_decode_idle()
        # a verify is ONE forward whatever its width: weights stream once
        self._account_chunk(delivered, elapsed, drec, nbytes)
        # per-row semantics on the shared gauge (1.0 = plain decode)
        self.spec_cfg.note_cycle(drafted, accepted, delivered, dispatches=len(records))

    def _spec_deliver_one(self, index: int, req: _Request, burst: list, n_acc: int,
                          drafted: int) -> int:
        """One row's share of a verify (pool lock held): the burst put,
        truncated at a stop token (never emitted nor committed), the
        budget and cache bookkeeping, the draft state's commit, and the
        finish. Returns the tokens delivered."""
        cancelled, expired = self._cut(req)
        hit_stop_token = False
        emit: list = []
        if not cancelled and not expired and req.out_queue is not None:
            for t in burst:
                if t in req.stop_tokens:
                    hit_stop_token = True
                    break
                emit.append(t)
            if emit:
                req.out_queue.put(list(emit))
        req.cache_len += len(emit)
        req.remaining -= len(emit)
        req.spec.commit(emit, drafted, n_acc)
        req.pending = req.spec.pending
        if req.record is not None:
            req.record.note_spec(drafted, n_acc, len(emit))
        if (cancelled or expired or hit_stop_token or req.remaining <= 0
                or req.cache_len >= self.max_len):
            self._finish_request(index, req, cancelled, expired)
        return len(emit)

    def occupancy(self) -> dict:
        """Point-in-time slot occupancy."""
        with self._work:
            return {
                "slots": self.n_slots,
                "active": len(self._active),
                "free": len(self._free),
                "chunk": self.chunk,
                "pipeline_depth": self.pipeline_depth,
                "dispatches": self.dispatches,
                "penalties": self._pen_mode,
                "penalized_slots": len(self._pen_slots),
                "lora_slots": len(self._lora_slots),
                "lora_chunks": self.lora_chunks,
                # chunks replayed from the captured graph, and those run
                # eagerly by reason (``chunk_path``)
                "graph_chunks": self.graph_chunks,
                "eager_chunks": dict(self.eager_chunks),
                "graph_capture_s": sum(g.capture_s for g in self._graphs.values()),
                "graph_pool_bytes": sum(g.pool_bytes for g in self._graphs.values()),
                "closed": self._closed,
                "rejects": dict(self.rejects),
                # the deadline admission gate's unit
                "chunk_cadence_s": self._chunk_ema_s,
                "spec": ({"k_max": self.spec_cfg.k_max, **self.spec_stats,
                          "widths": dict(self.spec_stats["widths"])}
                         if self.spec_cfg is not None else None),
                "kv": self._kv.stats() if self._kv is not None else None,
                # the serving mesh the slot cache is sharded over (None: one device)
                "mesh_axes": self.mesh_axes,
            }

    def close(self, timeout: float = CLOSE_TIMEOUT_S, strict: bool = True) -> bool:
        """Stop the worker and wait for it: once it has joined, the pool
        issues no more work on the card. Returns whether it joined. With
        ``strict`` a worker that outlives the join raises (a dispatch wedged
        on the host); a recovery teardown passes ``strict=False`` and a
        short ``timeout``: its worker may sit in a wedged wait, and leaves
        when the wait returns, failing its rows then."""
        with self._work:
            self._closed = True
            self._work.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            if strict:
                raise RuntimeError(f"decode pool worker still running {timeout}s after close")
            return False
        with self._work:
            # the worker replays no more: the graphs' memory goes back
            self._graphs.clear()
        return True
