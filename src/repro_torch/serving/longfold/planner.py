"""The long-fold memory planner: choose a chunk instead of rejecting.

The placement tier makes over-budget buckets *shardable*; this tier makes
them *chunkable*.  ``ChunkPolicy`` decides, per bucket, whether the trunk
runs unchunked or through the row-chunked pair stack
(``repro_torch.models.ppm.chunking``) and at what chunk size:

  * ``off``   — never chunk (the legacy path; also the default).
  * ``<int>`` — fixed chunk: buckets longer than the chunk run chunked at
    (the largest divisor of the bucket <=) that size.
  * ``auto``  — the planner: if a bucket's *unchunked* batch-1 estimate
    fits the per-device budget, leave it unchunked (chunking is never free
    — the scan serializes row slabs); otherwise pick the LARGEST chunk
    whose chunked estimate fits, i.e. the smallest-overhead plan that
    makes the bucket admittable.  If even the smallest chunk doesn't fit,
    the policy still reports that smallest chunk so the admission verdict
    (REJECT) is priced against the best plan available — the reason string
    then names what was actually tried.

The decision is a function of the bucket only (not the launch batch), so
one bucket maps to one executable-cache chunk label and the scheduler,
engine, and admission controller can never disagree about how a bucket
will run.  Estimates come from the ``AdmissionController`` itself (with
``chunk=`` forced explicitly, so there is no recursion through the wired
``chunk_for`` hook): one cost model, two consumers.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

from repro_torch.models.ppm.chunking import effective_chunk_size

if TYPE_CHECKING:                                     # pragma: no cover
    from repro_torch.serving.admission import AdmissionController

OFF = "off"
AUTO = "auto"
FIXED = "fixed"

#: smallest chunk auto mode will plan: below this the scan's serialization
#: overhead dominates any residual-memory win (the resident tensors, not
#: the slab, are the floor by then).
MIN_CHUNK = 16

#: the default per-device budget for the committed max-foldable-N curve
#: (BENCH_longfold.json) and the N=2,048 acceptance story: one commodity
#: 4 GB accelerator's worth of activations.
DEFAULT_LONGFOLD_BUDGET_MB = 4096.0


def parse_chunk_spec(spec) -> tuple[str, int | None]:
    """``--chunk-size`` value -> (mode, fixed_chunk).

    Accepts None/"off"/"none"/0 (off), "auto", or a positive int / int
    string (fixed).  Raises ValueError on anything else.
    """
    if spec is None:
        return OFF, None
    if isinstance(spec, str):
        s = spec.strip().lower()
        if s in ("", "off", "none", "0"):
            return OFF, None
        if s == AUTO:
            return AUTO, None
        try:
            spec = int(s)
        except ValueError:
            raise ValueError(
                f"--chunk-size must be 'off', 'auto', or a positive int; "
                f"got {spec!r}") from None
    if isinstance(spec, bool) or not isinstance(spec, int):
        raise ValueError(f"--chunk-size must be 'off', 'auto', or a "
                         f"positive int; got {spec!r}")
    if spec == 0:
        return OFF, None
    if spec < 0:
        raise ValueError(f"--chunk-size must be positive; got {spec}")
    return FIXED, spec


def chunk_candidates(ns: int, floor: int = MIN_CHUNK) -> list[int]:
    """Candidate chunks for a bucket, largest first: the power-of-two
    ladder from ns/2 down to ``floor``, snapped to divisors of ns (chunks
    must tile the row axis — see chunking.effective_chunk_size)."""
    out: list[int] = []
    c = 1
    while c * 2 < ns:
        c *= 2
    while c >= floor:
        e = effective_chunk_size(ns, c)
        if 1 < e < ns and e not in out:
            out.append(e)
        c //= 2
    return out


class ChunkPolicy:
    """Bucket -> chunk size (or None) for the whole serving stack.

    Wire ``policy.chunk_for`` into ``AdmissionController.chunk_for`` so
    pricing and execution can't diverge; the engine keys executables and
    the scheduler stamps batches through the same method.
    """

    def __init__(self, spec="off",
                 admission: "AdmissionController | None" = None):
        self.mode, self.fixed = parse_chunk_spec(spec)
        self.admission = admission
        self._plan: dict[int, int | None] = {}

    @property
    def enabled(self) -> bool:
        return self.mode != OFF

    def chunk_for(self, ns: int) -> int | None:
        """The chunk this bucket will fold with (None = unchunked)."""
        if ns not in self._plan:
            self._plan[ns] = self._decide(int(ns))
        return self._plan[ns]

    def _decide(self, ns: int) -> int | None:
        if self.mode == OFF:
            return None
        if self.mode == FIXED:
            if ns <= self.fixed:
                return None
            e = effective_chunk_size(ns, self.fixed)
            return e if 1 < e < ns else None
        return self._auto(ns)

    def _auto(self, ns: int) -> int | None:
        adm = self.admission
        if adm is None or adm.mem_budget_bytes is None:
            return None                      # nothing to plan against
        if adm.estimate_bytes(ns, 1, chunk=None) <= adm.mem_budget_bytes:
            return None                      # fits unchunked: don't pay scan
        cands = chunk_candidates(ns)
        for c in cands:                      # largest fitting = least overhead
            if adm.estimate_bytes(ns, 1, chunk=c) <= adm.mem_budget_bytes:
                return c
        return cands[-1] if cands else None  # best plan available; REJECT
                                             # verdicts price against it

    def label_for(self, ns: int) -> str:
        """Executable-cache / report label (no commas: lands in CSV)."""
        c = self.chunk_for(ns)
        return f"chunk:{c}" if c else "none"

    def describe(self) -> dict:
        """Run-level chunking facts for trace metadata / provenance."""
        d: dict = {"chunk_mode": self.mode}
        if self.mode == FIXED:
            d["chunk_fixed"] = self.fixed
        if self._plan:
            d["chunk_plan"] = {str(ns): c or 0
                               for ns, c in sorted(self._plan.items())}
        return d
