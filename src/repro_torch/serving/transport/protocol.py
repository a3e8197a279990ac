"""Versioned JSON wire schema for the fold-serving HTTP transport (port of
``repro/serving/transport/protocol.py``; byte-compatible with it: the same
array, result, status body or event encodes to the same bytes in both
packages, and each decodes the other's).

Pure encode/decode functions — no sockets, no HTTP — so the schema is
testable in isolation and both sides (the stdlib server and any client,
curl included) speak exactly this.

Arrays cross the wire as ``{"shape", "dtype", "b64"}`` with ``b64`` the
base64 of the raw C-contiguous bytes: a served coordinate array survives
an HTTP round trip **bitwise** (the fleet acceptance gate compares
network-served coords byte-for-byte against the in-process client).

Distograms are *opt-in*: ``encode_status``/``encode_result`` never touch
``FoldResult.distogram`` unless asked (``include_distogram=True`` — the
``?distogram=1`` query), so a plain status poll never triggers the
BxNxN device->host transfer a ``LazyDistogram`` defers.

Sequences are accepted either as a list of amino-acid ids (0..20) or as a
one-letter-code string over the standard 20-AA alphabet + ``X`` (unknown)
— what a curl user types.
"""
from __future__ import annotations

import base64
import dataclasses
import json
from typing import Any

import numpy as np

from repro_torch.serving import events as ev
from repro_torch.serving.types import FoldResult, LMResult

#: bump on any incompatible wire change; servers stamp it on every payload
PROTOCOL_VERSION = 1

#: one-letter amino-acid codes -> ids 0..20 (20 = X/unknown, matching
#: the sampler's AA_VOCAB=21 id space)
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYVX"
AA_TO_ID = {c: i for i, c in enumerate(AA_ALPHABET)}


class ProtocolError(ValueError):
    """A malformed or unserviceable wire payload.  ``http_status`` is the
    response code the server maps it to (400 unless stated otherwise)."""

    def __init__(self, message: str, http_status: int = 400):
        super().__init__(message)
        self.http_status = http_status


# -- arrays -----------------------------------------------------------------
def encode_array(arr: np.ndarray) -> dict:
    """Lossless array encoding: shape + dtype + base64 of the raw bytes.
    Takes host arrays only: a result reaches the wire as numpy, never as a
    device tensor that a later graph replay could overwrite."""
    a = np.ascontiguousarray(arr)
    return {"shape": list(a.shape), "dtype": str(a.dtype),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def decode_array(d: dict) -> np.ndarray:
    try:
        raw = base64.b64decode(d["b64"])
        arr = np.frombuffer(raw, dtype=np.dtype(d["dtype"]))
        return arr.reshape(d["shape"]).copy()
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed array payload: {e}") from None


# -- sequences --------------------------------------------------------------
def parse_sequence(obj: Any) -> np.ndarray:
    """Accept a one-letter-code string or a list of ids; return (L,) int32."""
    if isinstance(obj, str):
        seq = obj.strip().upper()
        if not seq:
            raise ProtocolError("empty sequence")
        bad = sorted({c for c in seq if c not in AA_TO_ID})
        if bad:
            raise ProtocolError(
                f"unknown amino-acid code(s) {bad} (alphabet "
                f"{AA_ALPHABET!r})")
        return np.array([AA_TO_ID[c] for c in seq], np.int32)
    if isinstance(obj, (list, tuple)):
        if not obj:
            raise ProtocolError("empty sequence")
        try:
            raw = np.asarray(obj)
        except (TypeError, ValueError):
            raise ProtocolError("sequence list must contain integers") \
                from None
        if raw.dtype.kind not in "iu":   # floats would silently truncate
            raise ProtocolError("sequence list must contain integers")
        arr = raw.astype(np.int32)
        if arr.ndim != 1:
            raise ProtocolError(f"sequence must be 1-D, got shape "
                                f"{arr.shape}")
        if arr.min() < 0 or arr.max() >= len(AA_ALPHABET):
            raise ProtocolError(f"amino-acid ids must be in [0, "
                                f"{len(AA_ALPHABET) - 1}]")
        return arr
    raise ProtocolError(f"sequence must be a string or a list of ids, "
                        f"got {type(obj).__name__}")


def _parse_scheduling(doc: dict) -> tuple[int, float | None]:
    priority = doc.get("priority", 0)
    if not isinstance(priority, int) or isinstance(priority, bool):
        raise ProtocolError("priority must be an integer")
    deadline_s = doc.get("deadline_s")
    if deadline_s is not None:
        if not isinstance(deadline_s, (int, float)) \
                or isinstance(deadline_s, bool) or deadline_s <= 0:
            raise ProtocolError("deadline_s must be a positive number")
        deadline_s = float(deadline_s)
    return priority, deadline_s


def parse_submit(body: bytes) -> tuple[np.ndarray, int, float | None]:
    """Parse a ``POST /v1/fold`` body -> (sequence, priority, deadline_s)."""
    try:
        doc = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"body is not valid JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ProtocolError("body must be a JSON object")
    unknown = set(doc) - {"sequence", "priority", "deadline_s"}
    if unknown:
        raise ProtocolError(f"unknown field(s) {sorted(unknown)}")
    if "sequence" not in doc:
        raise ProtocolError("missing required field 'sequence'")
    seq = parse_sequence(doc["sequence"])
    priority, deadline_s = _parse_scheduling(doc)
    return seq, priority, deadline_s


def parse_generate(body: bytes) -> tuple[np.ndarray, int, float | None,
                                         int | None]:
    """Parse a ``POST /v1/generate`` body -> (prompt token ids, priority,
    deadline_s, max_new_tokens).  The prompt is a list of non-negative
    token ids — the LM workload's vocabulary, not the AA alphabet."""
    try:
        doc = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"body is not valid JSON: {e}") from None
    if not isinstance(doc, dict):
        raise ProtocolError("body must be a JSON object")
    unknown = set(doc) - {"prompt", "max_new_tokens", "priority",
                          "deadline_s"}
    if unknown:
        raise ProtocolError(f"unknown field(s) {sorted(unknown)}")
    if "prompt" not in doc:
        raise ProtocolError("missing required field 'prompt'")
    raw = doc["prompt"]
    if not isinstance(raw, (list, tuple)) or not raw:
        raise ProtocolError("prompt must be a non-empty list of token ids")
    try:
        arr = np.asarray(raw)
    except (TypeError, ValueError):
        raise ProtocolError("prompt must contain integers") from None
    if arr.dtype.kind not in "iu" or arr.ndim != 1:
        raise ProtocolError("prompt must be a flat list of integers")
    if arr.min() < 0:
        raise ProtocolError("token ids must be non-negative")
    mnt = doc.get("max_new_tokens")
    if mnt is not None:
        if not isinstance(mnt, int) or isinstance(mnt, bool) or mnt < 1:
            raise ProtocolError("max_new_tokens must be an integer >= 1")
    priority, deadline_s = _parse_scheduling(doc)
    return arr.astype(np.int32), priority, deadline_s, mnt


# -- results ----------------------------------------------------------------
def encode_result(r: FoldResult, *, include_distogram: bool = False) -> dict:
    """FoldResult -> wire dict.  The distogram is only materialized (and
    only then transferred device->host, if still lazy) when explicitly
    asked for — the lazy-transfer contract holds across the network."""
    out = {
        "request_id": r.request_id, "length": r.length, "status": r.status,
        "reason": r.reason, "bucket": r.bucket, "batch_size": r.batch_size,
        "priority": r.priority, "queue_wait_ms": r.queue_wait_ms,
        "compile_ms": r.compile_ms, "run_ms": r.run_ms,
        "launched_batch": r.launched_batch, "occupancy": r.occupancy,
        "tm_vs_fp": r.tm_vs_fp, "kernel_backend": r.kernel_backend,
        "placement": r.placement, "chunk_size": r.chunk_size,
        "coords": None if r.coords is None else encode_array(r.coords),
        "distogram": None,
    }
    if include_distogram and r.distogram is not None:
        out["distogram"] = encode_array(np.asarray(r.distogram))
    return out


def decode_result(d: dict) -> FoldResult:
    """Wire dict -> FoldResult (arrays restored bitwise)."""
    known = {f.name for f in dataclasses.fields(FoldResult)}
    kw = {k: v for k, v in d.items() if k in known}
    if kw.get("coords") is not None:
        kw["coords"] = decode_array(kw["coords"])
    if kw.get("distogram") is not None:
        kw["distogram"] = decode_array(kw["distogram"])
    try:
        return FoldResult(**kw)
    except TypeError as e:
        raise ProtocolError(f"malformed result payload: {e}") from None


def encode_lm_result(r, *, include_logits: bool = False) -> dict:
    """LMResult -> wire dict.  Generated tokens cross as a plain id list;
    ``logits_first`` (the drift-probe vector) is opt-in, like the fold
    distogram — a status poll never ships a (V,) float array."""
    out = {
        "request_id": r.request_id, "prompt_len": r.prompt_len,
        "status": r.status, "reason": r.reason,
        "tokens": None if r.tokens is None else [int(t) for t in r.tokens],
        "max_new_tokens": r.max_new_tokens, "priority": r.priority,
        "queue_wait_ms": r.queue_wait_ms, "compile_ms": r.compile_ms,
        "run_ms": r.run_ms, "steps": r.steps, "slot": r.slot,
        "kv_bytes": r.kv_bytes, "kernel_backend": r.kernel_backend,
        "scheme": r.scheme, "logits_first": None,
    }
    if include_logits and r.logits_first is not None:
        out["logits_first"] = encode_array(r.logits_first)
    return out


def decode_lm_result(d: dict) -> LMResult:
    """Wire dict -> LMResult (token list restored as int32)."""
    known = {f.name for f in dataclasses.fields(LMResult)}
    kw = {k: v for k, v in d.items() if k in known}
    if kw.get("tokens") is not None:
        kw["tokens"] = np.asarray(kw["tokens"], np.int32)
    if kw.get("logits_first") is not None:
        kw["logits_first"] = decode_array(kw["logits_first"])
    try:
        return LMResult(**kw)
    except TypeError as e:
        raise ProtocolError(f"malformed result payload: {e}") from None


def encode_status(record, *, include_distogram: bool = False) -> dict:
    """A fleet record's status payload (``GET /v1/fold/<id>`` or
    ``GET /v1/generate/<id>``).

    ``record`` is a ``fleet.FleetRecord``; the result rides along only
    once the handle is terminal.  The result encoding dispatches on the
    result type, so fold and LM records share one status schema."""
    handle = record.handle
    state = handle.status
    out = {
        "v": PROTOCOL_VERSION,
        "id": record.request_id,
        "state": state,
        "done": handle.done,
        "length": handle.length,
        "priority": handle.priority,
        "deadline_s": handle.deadline_s,
        "replica": record.replica_index,
        "requeues": record.requeues,
        "events": len(record.events),
        "result": None,
    }
    if handle.done:
        r = handle._result
        if isinstance(r, FoldResult):
            out["result"] = encode_result(
                r, include_distogram=include_distogram)
        else:
            out["workload"] = "lm"
            out["result"] = encode_lm_result(
                r, include_logits=include_distogram)
    return out


# -- events / SSE -----------------------------------------------------------
def encode_event(e: ev.FoldEvent) -> dict:
    data = {}
    for k, v in e.data.items():     # tuples (batch ids) -> lists for JSON
        data[k] = list(v) if isinstance(v, tuple) else v
    return {"seq": e.seq, "kind": e.kind, "request_id": e.request_id,
            "t": e.t, "data": data}


def decode_event(d: dict) -> ev.FoldEvent:
    try:
        return ev.FoldEvent(seq=int(d["seq"]), kind=d["kind"],
                            request_id=int(d["request_id"]),
                            t=float(d["t"]), data=dict(d.get("data") or {}))
    except (KeyError, TypeError, ValueError) as e:
        raise ProtocolError(f"malformed event payload: {e}") from None


def sse_frame(e: ev.FoldEvent) -> bytes:
    """One Server-Sent-Events frame: ``event:`` = kind, ``data:`` = the
    JSON event payload, ``id:`` = the bus sequence number."""
    payload = json.dumps(encode_event(e))
    return (f"id: {e.seq}\nevent: {e.kind}\ndata: {payload}\n\n"
            .encode("utf-8"))


def parse_sse(body: str | bytes) -> list[ev.FoldEvent]:
    """Parse a full SSE stream body back into FoldEvents (what the CI job
    and tests use to assert event ordering over the wire)."""
    if isinstance(body, bytes):
        body = body.decode("utf-8")
    out = []
    for frame in body.split("\n\n"):
        for line in frame.splitlines():
            if line.startswith("data:"):
                out.append(decode_event(json.loads(line[5:].strip())))
    return out
