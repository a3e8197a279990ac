"""Request/response types for the fold-serving engine (port of
``repro/serving/types.py``).

A ``FoldRequest`` is an amino-acid sequence plus its scheduling attributes
(priority tier, optional deadline); a ``FoldResult`` carries the
masked-length-stripped outputs (coords/distogram only over real tokens) plus
the per-request serving telemetry the metrics module aggregates.

Clock contract: every request-lifecycle timestamp (``arrival_time``,
``deadline_at``, batch-start times, event timestamps) comes from ONE
monotonic clock — ``time.monotonic`` by default, injectable on the client
for tests.  Wall-clock ``time.time()`` is never used: an NTP step between
submit and batch start would make queue_wait_ms negative.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch

def _to_numpy(t) -> np.ndarray:
    """A tensor (any device) as a host numpy array; bfloat16 as float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class BatchDeviceOutput:
    """One device->host transfer, shared by every LazyDistogram in a batch.

    Holds the batch's device tensor until the first ``host()`` call, which
    copies the whole batch to the host exactly once (numpy slicing after
    that: one transfer a batch, not one a row) and then drops the device
    reference so the device buffer can be freed.  A bfloat16 tensor arrives
    as float32 (exact; numpy has no bfloat16).  Thread-safe: the background
    driver may retire batches while a consumer fetches on another thread.
    """

    def __init__(self, device_array: Any, nbytes: int = 0,
                 on_release: Any = None):
        self._device = device_array
        self._host: np.ndarray | None = None
        self._lock = threading.Lock()
        #: device bytes this output pins until first host() (telemetry)
        self.nbytes = int(nbytes)
        self._on_release = on_release

    @property
    def materialized(self) -> bool:
        return self._host is not None

    def host(self) -> np.ndarray:
        release = None
        with self._lock:
            if self._host is None:
                self._host = _to_numpy(self._device)
                self._device = None          # release the device buffer
                release, self._on_release = self._on_release, None
            host = self._host
        if release is not None:    # outside the lock: callback feeds a
            release()              # metrics gauge with its own lock
        return host


class LazyDistogram:
    """On-demand distogram view of one request's rows in a batch output.

    For long sequences the B x N x N x bins distogram is the peak
    *host*-memory term of a served batch — the paper's Sec. 3 activation
    bottleneck restated host-side — so the pipelined engine defers its
    device->host transfer until a consumer actually asks.  The handle is
    array-like: ``np.asarray(handle)`` (the numpy ``__array__`` protocol),
    ``handle[...]``, and ``handle.fetch()`` all materialize the stripped
    ``(L, L, bins)`` array (cached; the shared batch transfer happens once
    per batch, on first ask from any request in it).  ``shape`` is known
    without fetching.  Handles stay valid after the engine has moved on to
    later batches.

    Memory note: until the first fetch, the handle keeps its batch's
    device buffer alive — a consumer that never reads any distogram of a
    batch pins that batch's device array for as long as its FoldResults
    are referenced (``EngineMetrics.results`` holds every result until the
    metrics object is reset).  Pass ``keep_distogram=False`` to servers
    that never serve distograms; a byte-bounded spill/eviction policy is
    not built.
    """

    def __init__(self, batch: BatchDeviceOutput, row: int, length: int,
                 bins: int):
        self._batch: BatchDeviceOutput | None = batch
        self._row = row
        self._length = length
        self._bins = bins
        self._arr: np.ndarray | None = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self._length, self._length, self._bins)

    ndim = 3

    @property
    def materialized(self) -> bool:
        """Has THIS request's slice been fetched to host yet?"""
        return self._arr is not None

    def fetch(self) -> np.ndarray:
        """Materialize (once) and return the stripped (L, L, bins) array.

        Thread-safe without a lock: ``_arr`` is published BEFORE the batch
        reference is dropped, so a concurrent fetch either sees the batch
        (and recomputes the same slice — benign) or sees ``_arr`` already
        set; ``BatchDeviceOutput.host()`` itself is locked.
        """
        arr = self._arr
        if arr is not None:
            return arr
        batch = self._batch
        if batch is None:          # raced with a finishing fetch: _arr is
            return self._arr       # set before _batch is cleared
        host = batch.host()
        arr = np.array(host[self._row, :self._length, :self._length])
        self._arr = arr            # publish, THEN drop the batch ref
        self._batch = None
        return arr

    def __array__(self, dtype=None, copy=None):
        arr = self.fetch()
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, idx):
        return self.fetch()[idx]

    def __len__(self) -> int:
        return self._length

    def __repr__(self) -> str:
        state = "materialized" if self.materialized else "lazy"
        return f"LazyDistogram(shape={self.shape}, {state})"


OK = "ok"
REJECTED = "rejected"
CANCELLED = "cancelled"
EXPIRED = "expired"
FAILED = "failed"          # batch execution raised; request is terminal
TERMINAL_STATUSES = (OK, REJECTED, CANCELLED, EXPIRED, FAILED)


@dataclasses.dataclass
class FoldRequest:
    request_id: int
    aatype: np.ndarray                 # (L,) int32 amino-acid ids
    arrival_time: float = 0.0          # client clock, set on submit
    priority: int = 0                  # larger = more urgent; ties are FCFS
    deadline_s: float | None = None    # relative budget from submit
    deadline_at: float | None = None   # absolute, client clock; set on submit
    cancelled: bool = False            # set by FoldHandle.cancel()
    max_new_tokens: int | None = None  # LM decode only: generation budget
                                       # (``aatype`` doubles as the prompt);
                                       # a fold ignores it

    def __post_init__(self):
        self.aatype = np.asarray(self.aatype, np.int32)
        if self.aatype.ndim != 1:
            raise ValueError(f"aatype must be 1-D, got {self.aatype.shape}")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"deadline_s must be positive, got {self.deadline_s}")
        if self.max_new_tokens is not None and self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {self.max_new_tokens}")

    @property
    def length(self) -> int:
        return int(self.aatype.shape[0])

    def expired(self, now: float) -> bool:
        return self.deadline_at is not None and now >= self.deadline_at


@dataclasses.dataclass
class FoldResult:
    request_id: int
    length: int
    status: str = OK           # OK | REJECTED | CANCELLED | EXPIRED | FAILED
    reason: str = ""
    bucket: int = 0
    batch_size: int = 0
    coords: np.ndarray | None = None           # (L, 3) — padding stripped
    distogram: np.ndarray | LazyDistogram | None = None
                                       # (L, L, bins) stripped — the
                                       # pipelined engine hands out a
                                       # LazyDistogram (array-like, fetched
                                       # on first consumer ask)
    tm_vs_fp: float | None = None              # fidelity vs FP16 reference
    priority: int = 0
    queue_wait_ms: float = 0.0         # arrival -> executable resolved (a
                                       # cold capture is queue time for the
                                       # requests waiting on it)
    compile_ms: float = 0.0            # graph capture of its key; 0 on
                                       # executable-cache hits
    run_ms: float = 0.0                # launch -> outputs ready; with
                                       # inflight_depth > 1 this includes
                                       # time queued behind the previous
                                       # in-flight batch on the device
    launched_batch: int = 0            # rows the executable actually ran
                                       # (>= batch_size; dummy rows only
                                       # when a cached size was reused)
    occupancy: float = 0.0             # real tokens / (launched_batch *
                                       # bucket) of its batch
    est_activation_bytes: int = 0      # admission-control price of its batch
                                       # (per-device under a sharded placement)
    kernel_backend: str = ""           # dispatch label the batch ran under
                                       # (ref | kernel | kernel-plain | auto:*)
    placement: str = "single"          # device placement its executable ran
                                       # under ("single" | "mesh:DxM")
    chunk_size: int = 0                # row-chunk the trunk executed with
                                       # (0 = unchunked; the long-fold
                                       # planner's per-bucket plan)

    @property
    def ok(self) -> bool:
        return self.status == OK

    @property
    def padding_frac(self) -> float:
        """Fraction of the bucket row this request wasted as padding."""
        if not self.bucket:
            return 0.0
        return 1.0 - self.length / self.bucket


@dataclasses.dataclass
class LMResult:
    """Per-request decode outcome of the LM tenant (the reference keeps it
    in ``repro/serving/lm.py``): the wire protocol encodes and decodes it,
    so its fields are defined here ahead of the tenant itself."""

    request_id: int
    prompt_len: int
    status: str = OK
    reason: str = ""
    tokens: np.ndarray | None = None   # (n,) int32 generated token ids
    max_new_tokens: int = 0
    priority: int = 0
    queue_wait_ms: float = 0.0         # arrival -> slot join
    compile_ms: float = 0.0            # decode-step captures it waited on
    run_ms: float = 0.0                # its share of step wall time
    steps: int = 0                     # decode steps it occupied a slot for
    slot: int = -1
    kv_bytes: int = 0                  # admission price of its KV slot
    kernel_backend: str = ""
    scheme: str = ""
    logits_first: np.ndarray | None = None
                                       # (V,) f32 logits of the first
                                       # generated position

    @property
    def ok(self) -> bool:
        return self.status == OK

    @property
    def new_tokens(self) -> int:
        return 0 if self.tokens is None else int(len(self.tokens))


def pad_to_bucket(seqs: list[np.ndarray], bucket: int,
                  batch: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Right-pad sequences into an (B, bucket) aatype batch + bool mask.

    ``batch`` > len(seqs) appends fully-masked dummy rows (batch-size
    rounding keeps the executable-cache key space small); dummy rows are
    finite-garbage-safe because masking never lets them touch real rows.
    """
    b = batch or len(seqs)
    if b < len(seqs):
        raise ValueError(f"batch {b} < {len(seqs)} sequences")
    aatype = np.zeros((b, bucket), np.int32)
    mask = np.zeros((b, bucket), bool)
    for i, s in enumerate(seqs):
        ln = len(s)
        if ln > bucket:
            raise ValueError(f"sequence len {ln} exceeds bucket {bucket}")
        aatype[i, :ln] = s
        mask[i, :ln] = True
    return aatype, mask


