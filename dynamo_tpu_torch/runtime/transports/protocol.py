"""Wire-protocol discriminator constants — the single source of truth.

A copy of the JAX package's ``runtime/transports/protocol.py``: the
literals both packages put on the wire.

Every cross-process message in the runtime transports is a framed JSON
header (transports/framing.py) whose dispatch key is a string literal:
the coordinator's ``op``, the TCP endpoint plane's frame ``type``, and
the KV-transfer plane's ``op``.  Scattering those literals across
producer (client) and consumer (server dispatch) modules is exactly the
drift the wire-plane static analysis (analysis/wirecheck.py, rule
WR003) exists to catch — this module removes the drift surface by
giving both sides one name to import.

Plain ``str`` class attributes, not ``enum.Enum``: the values go
straight into ``json.dumps`` headers and ``==`` dispatch comparisons,
and the wire checker resolves ``CoordOp.KV_PUT`` to its literal through
the AST, so a wrapper type would only add indirection on the hot path.
"""

from __future__ import annotations

__all__ = ["CoordOp", "FrameType", "TransferOp", "TRACE_FIELD"]

# Optional trace-context header field (dtspan plane, obs/tracing.py):
# value is a two-element ``[trace_id, span_id]`` list stamped by
# ``obs.tracing.inject`` on TCP REQUEST frames, coordinator commands,
# KV-transfer headers and remote-prefill queue payloads, and read back
# by ``obs.tracing.extract`` on the consuming side.  Absent whenever
# tracing is disabled — every consumer treats it as optional.
TRACE_FIELD = "trace"


class CoordOp:
    """Coordinator request/push header ``op`` values.

    Requests (client -> server, replied to by ``id`` echo) cover the KV,
    watch, lease, pub/sub, queue and blob planes; ``WATCH_EVENT`` and
    ``MESSAGE`` are server-initiated pushes (no ``id``).
    """

    # KV plane
    KV_PUT = "kv_put"
    KV_CREATE = "kv_create"
    KV_CREATE_OR_VALIDATE = "kv_create_or_validate"
    KV_GET = "kv_get"
    KV_GET_PREFIX = "kv_get_prefix"
    KV_DELETE = "kv_delete"
    # watch plane
    WATCH = "watch"
    UNWATCH = "unwatch"
    # lease plane
    LEASE_CREATE = "lease_create"
    LEASE_KEEPALIVE = "lease_keepalive"
    LEASE_REVOKE = "lease_revoke"
    # pub/sub plane
    SUBSCRIBE = "subscribe"
    UNSUBSCRIBE = "unsubscribe"
    PUBLISH = "publish"
    # queue plane
    QUEUE_PUSH = "queue_push"
    QUEUE_PULL = "queue_pull"
    QUEUE_ACK = "queue_ack"
    QUEUE_NACK = "queue_nack"
    QUEUE_LEN = "queue_len"
    # blob plane
    BLOB_BEGIN = "blob_begin"
    BLOB_CHUNK = "blob_chunk"
    BLOB_COMMIT = "blob_commit"
    BLOB_READ = "blob_read"
    BLOB_STAT = "blob_stat"
    BLOB_LIST = "blob_list"
    BLOB_DELETE = "blob_delete"
    # health
    PING = "ping"
    # server -> client pushes
    WATCH_EVENT = "watch_event"
    MESSAGE = "message"


class FrameType:
    """TCP endpoint plane (transports/tcp.py) frame ``type`` values.

    ``REQUEST``/``STOP``/``KILL``/``PING`` flow client -> server;
    ``ITEM``/``END``/``ERROR``/``PONG`` flow server -> client.
    """

    REQUEST = "request"
    STOP = "stop"
    KILL = "kill"
    PING = "ping"
    ITEM = "item"
    END = "end"
    ERROR = "error"
    PONG = "pong"


class TransferOp:
    """KV-block transfer plane (llm/kv/transfer.py) header ``op`` values.

    The ``STREAM_*``/``WRITE_LAYER`` quartet is the layer-wise streamed
    handoff session (llm/kv/stream.py): a versioned ``STREAM_BEGIN``
    opens a per-request session, ``WRITE_LAYER`` frames carry one
    layer's blocks each under a per-session monotonic ``seq``, and
    ``STREAM_END`` closes with a payload sha256 so a torn stream is a
    verifiable miss — never silently-wrong KV.  ``STREAM_ABORT`` is the
    producer-side give-up (fallback to whole-cache ``WRITE_BLOCKS``).
    """

    WRITE_BLOCKS = "write_blocks"
    READ_BLOCKS = "read_blocks"
    NOTIFY = "notify"
    # streamed layer-wise handoff session (llm/kv/stream.py)
    STREAM_BEGIN = "stream_begin"
    WRITE_LAYER = "write_layer"
    STREAM_END = "stream_end"
    STREAM_ABORT = "stream_abort"
