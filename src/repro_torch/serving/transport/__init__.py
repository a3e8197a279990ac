"""repro_torch.serving.transport: network front-end for the fold engine
(port of ``repro/serving/transport``).

Three layers, bottom-up:

  * ``protocol``  — the versioned JSON wire schema: submit bodies,
    status/result payloads (arrays ride as base64-of-raw-bytes so an HTTP
    round trip is bitwise-lossless), SSE event framing.
  * ``fleet``     — ``FleetRouter``: N engine replicas (one ``FoldClient``
    + background driver each), routing each request on live queue-depth/
    in-flight telemetry read from the replicas' own metrics registries,
    with per-replica failure isolation (a dead driver marks the replica
    unhealthy and its queued requests are drained back to the router and
    resubmitted elsewhere).
  * ``server``    — ``FoldHTTPServer``: the stdlib ``http.server``
    front-end (``POST /v1/fold``, ``GET /v1/fold/<id>``, SSE
    ``/v1/fold/<id>/events``, ``DELETE /v1/fold/<id>``, ``/healthz``,
    ``/metrics``) over a ``FleetRouter``.
"""
from repro_torch.serving.transport.fleet import FleetRecord, FleetRouter, Replica
from repro_torch.serving.transport.protocol import (PROTOCOL_VERSION, ProtocolError,
                                              decode_array, decode_event,
                                              decode_result, encode_array,
                                              encode_event, encode_result,
                                              encode_status, parse_sequence,
                                              parse_sse, parse_submit,
                                              sse_frame)
from repro_torch.serving.transport.server import FoldHTTPServer

__all__ = [
    "PROTOCOL_VERSION", "ProtocolError",
    "encode_array", "decode_array", "encode_result", "decode_result",
    "encode_status", "encode_event", "decode_event", "sse_frame",
    "parse_sse", "parse_sequence", "parse_submit",
    "FleetRouter", "FleetRecord", "Replica",
    "FoldHTTPServer",
]
