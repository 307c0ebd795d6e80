"""The ONE Python mirror of the PS wire protocol laid down in csrc/ps/*.h.

Every Python-side unpacker of a C++ reply (elastic coordinator, PSClient
ctypes stats, supervisor probes, recovery manifest checks, chaos event
drains) imports its slot counts, field names, header structs, flags and
enum values from here — never a per-file magic number. ``bin/hetucheck``
(docs/ANALYSIS.md, Tier D) parses the C++ headers and asserts this module
matches them slot-for-slot, so drift between the languages fails CI
instead of corrupting an unpack at 3am.

Layout provenance (file:symbol of the C++ truth):

- ``MSG_HDR`` / ``ARG_HDR``     — net.h ``MsgHeader`` / ``ArgHeader``
- ``PSF``                       — net.h ``enum class PsfType``
- ``AT_*``                      — net.h ``enum class ArgType``
- ``FLAG_*`` / ``QUANT_WIRE_BLOCK`` — net.h wire flag constants
- ``SERVER_STATS_FIELDS``       — server.h kServerStats reply
- ``SNAPSHOT_NOW_FIELDS``       — server.h kSnapshotNow reply
- ``LIST_PARAMS_FIELDS``        — server.h kListParams row stride
- ``CLIENT_STATS_FIELDS``       — worker.h ``client_stats()``
- ``TRAIL_SPAN_FIELDS``         — worker.h ``kTrailCols`` drain rows
- ``RESIZE_STATE_FIELDS``       — scheduler.h kResizeState reply
- ``WORLD_REPLY_FIELDS``        — scheduler.h ``world_reply_locked``
- ``CHAOS_EVENT_FIELDS`` / ``CHAOS_KINDS`` — chaos.h ``ChaosEngine``
- ``SHARD_MAGIC_V2`` / ``SHARD_META_LEN`` / ``OPT_SLOT_COUNTS``
                                — server.h v2 shard format + store.h OptType

jax-free on purpose: hetucheck imports this under plain CPython in CI.
"""
from __future__ import annotations

import struct

# --------------------------------------------------------------------------
# Message framing — net.h MsgHeader / ArgHeader. ArgHeader's middle i32 is
# the documented field-reuse slot: ``pad`` on the wire, carrying the CRC32C
# of the arg bytes when the message's FLAG_CRC is set. MsgHeader's last i32
# was ``pad`` pre-elastic and is now ``world_ver`` (membership epoch stamp);
# the wire layout never changed, only the meaning of the slot.
MSG_HDR = struct.Struct("<iiQiiii")   # 32 bytes
MSG_HDR_FIELDS = ("type", "tensor_id", "req_id", "n_args", "flags",
                  "client_id", "world_ver")
ARG_HDR = struct.Struct("<iiQ")       # 16 bytes
ARG_HDR_FIELDS = ("dtype", "crc_or_pad", "nbytes")

# net.h wire flags + quantization block
FLAG_QUANT_RSP = 1      # kFlagQuantRsp: response values may ride kQI8
FLAG_CRC = 2            # kFlagCrc: per-arg CRC32C in ArgHeader.pad
QUANT_WIRE_BLOCK = 256  # kQuantWireBlock: dense int8 scale granularity

# net.h enum class ArgType
AT_F32, AT_I64, AT_F64, AT_BYTES, AT_I32, AT_U64, AT_QI8 = range(7)

# --------------------------------------------------------------------------
# net.h enum class PsfType — the full request vocabulary. hetucheck diffs
# this dict against the parsed enum, so adding a PSF in C++ without
# mirroring it here is a CI failure (and vice versa).
PSF = {
    "kRegister": 0, "kAddressBook": 1, "kBarrier": 2, "kShutdown": 3,
    "kAck": 4, "kHeartbeat": 5, "kQueryServers": 6, "kServerStats": 7,
    "kDensePush": 10, "kDensePull": 11, "kDDPushPull": 12,
    "kSparsePush": 20, "kSparsePull": 21, "kSDPushPull": 22,
    "kSSPushPull": 23,
    "kParamInit": 30, "kParamClear": 31, "kParamSave": 32, "kParamLoad": 33,
    "kParamAssign": 34, "kParamAssignRows": 35,
    "kSyncEmbedding": 40, "kPushEmbedding": 41, "kPushSyncEmbedding": 42,
    "kDataPush": 50, "kDataPull": 51,
    "kProposeResize": 60, "kResizeState": 61, "kCommitResize": 62,
    "kFinishResize": 63, "kResizeLog": 64, "kListParams": 65,
    "kSetWorldVersion": 66, "kSnapshotNow": 67,
    "kTestSlowApply": 70,
}

# The ids Python-side coordinators put on the wire themselves (elastic.py,
# supervisor.py speak raw sockets; everything else goes through ctypes).
K_QUERY_SERVERS = PSF["kQueryServers"]
K_SERVER_STATS = PSF["kServerStats"]
K_PARAM_SAVE = PSF["kParamSave"]
K_PARAM_LOAD = PSF["kParamLoad"]
K_PROPOSE_RESIZE = PSF["kProposeResize"]
K_RESIZE_STATE = PSF["kResizeState"]
K_COMMIT_RESIZE = PSF["kCommitResize"]
K_FINISH_RESIZE = PSF["kFinishResize"]
K_RESIZE_LOG = PSF["kResizeLog"]
K_LIST_PARAMS = PSF["kListParams"]
K_SET_WORLD_VERSION = PSF["kSetWorldVersion"]
K_SNAPSHOT_NOW = PSF["kSnapshotNow"]

# --------------------------------------------------------------------------
# Reply slot layouts. The tuples are in C++ slot order; ``len(...)`` is the
# count to request/unpack. Unpack helpers below build the canonical dicts so
# consumers key on names, never indices.

# server.h kServerStats: int64_t stats[11]
SERVER_STATS_FIELDS = (
    "updates",            # 0 optimizer updates applied
    "snapshot_updates",   # 1 updates covered by the latest snapshot
    "restored_updates",   # 2 counter restored from (-1 = fresh start)
    "snapshot_version",   # 3 latest published snapshot version
    "n_params",           # 4 live param count
    "requests",           # 5 requests served
    "apply_ns",           # 6 total apply wall ns (writes only)
    "apply_count",        # 7 apply sample count
    "snapshot_age_ms",    # 8 ms since last snapshot (-1 = none yet)
    "dedup_clients",      # 9 dedup-ledger occupancy
    "crc_rejects",        # 10 CRC-rejected requests
)
SERVER_STATS_SLOTS = len(SERVER_STATS_FIELDS)

# worker.h client_stats(): 10 relaxed counters in declaration order
CLIENT_STATS_FIELDS = (
    "rpcs",               # 0 rpc_count_
    "retries",            # 1 retry_count_
    "failovers",          # 2 failover_count_
    "quant_raw_bytes",    # 3 val_raw_bytes_
    "quant_wire_bytes",   # 4 val_wire_bytes_
    "timeouts",           # 5 timeout_count_
    "backoff_ms",         # 6 backoff_ms_total_
    "crc_rejects",        # 7 crc_reject_count_
    "chaos_faults",       # 8 chaos_faults()
    "pushes_ok",          # 9 push_ok_count_
)
CLIENT_STATS_SLOTS = len(CLIENT_STATS_FIELDS)

# server.h kSnapshotNow reply: int64_t out[4]
SNAPSHOT_NOW_FIELDS = ("version", "counter", "updates", "epoch")
SNAPSHOT_NOW_SLOTS = len(SNAPSHOT_NOW_FIELDS)

# server.h kListParams: flat i64 rows, one per stored param
LIST_PARAMS_FIELDS = ("key", "kind", "size", "width", "otype")
LIST_PARAMS_STRIDE = len(LIST_PARAMS_FIELDS)

# scheduler.h kResizeState: int64_t vals[13] (slots 10-12 are suffix
# extensions — slot 10 hetusave, 11-12 hetupilot — older clients reading
# a shorter prefix stay valid)
RESIZE_STATE_FIELDS = (
    "world_version", "pending_version", "num_workers", "num_servers",
    "pending_nw", "pending_ns", "drained", "survivors",
    "new_servers_ready", "members", "snapshot_epochs",
    "pilot_commit_epochs", "pilot_rollback_epochs",
)
RESIZE_STATE_SLOTS = len(RESIZE_STATE_FIELDS)

# scheduler.h kFinishResize second i32 (the actuation tag): WHY an
# identity-resize barrier era was run, so the kResizeState era counters
# attribute each era to its cause. 0/absent = a plain resize or an
# untagged abort (counted nowhere); "snapshot" = a hetusave coordinated
# epoch (counts snapshot_epochs); "pilot_commit"/"pilot_rollback" = a
# hetupilot actuation verdict (counts pilot_*_epochs). The legacy bool
# (snapshot=True) is tag 1 — exactly-once epoch counting is unchanged.
ACTUATION_TAGS = {
    "none": 0, "snapshot": 1, "pilot_commit": 2, "pilot_rollback": 3,
}

# scheduler.h world_reply_locked: int64_t vals[5]
WORLD_REPLY_FIELDS = ("world_version", "num_workers", "num_servers",
                      "dp_rank", "start_step")
WORLD_REPLY_SLOTS = len(WORLD_REPLY_FIELDS)

# worker.h kTrailCols drain rows (DrainTrailSpans)
TRAIL_SPAN_FIELDS = ("req_id", "client_id", "server", "psf", "tensor",
                     "step", "t0_us", "dur_us", "req_bytes", "rsp_bytes")
TRAIL_COLS = len(TRAIL_SPAN_FIELDS)

# chaos.h ChaosEngine: drain() row layout + enum class ChaosKind
CHAOS_EVENT_FIELDS = ("kind", "server", "psf", "tensor", "seq", "arg")
CHAOS_EVENT_COLS = len(CHAOS_EVENT_FIELDS)
CHAOS_KINDS = {
    "kNone": 0, "kDrop": 1, "kDelay": 2, "kDup": 3, "kReorder": 4,
    "kCorrupt": 5, "kPartition": 6, "kDropRsp": 7,
}

# --------------------------------------------------------------------------
# server.h v2 full-state shard format + store.h OptType slot counts (how
# many auxiliary state tensors each server-side optimizer persists).
SHARD_MAGIC_V2 = -2
SHARD_META_LEN = 8
# store.h enum class OptType + how many aux tensors alloc_slots() gives each
OPT_TYPES = {"kSGD": 0, "kMomentum": 1, "kNesterov": 2, "kAdaGrad": 3,
             "kAdam": 4}
OPT_SLOT_COUNTS = {0: 0,   # kSGD      (stateless)
                   1: 1,   # kMomentum (accum)
                   2: 1,   # kNesterov (accum)
                   3: 1,   # kAdaGrad  (accum)
                   4: 2}   # kAdam     (accum, accum2)


def unpack_fields(fields, vals) -> dict:
    """Zip a C++ i64 reply into its canonical dict. Tolerates a longer
    reply (suffix extensions, e.g. kResizeState slot 10) but never a
    shorter one — a short reply is exactly the drift this module exists
    to catch, so fail loudly at the unpack site."""
    vals = list(vals)
    if len(vals) < len(fields):
        raise ValueError(
            f"wire reply has {len(vals)} slot(s), expected at least "
            f"{len(fields)}: {fields} — C++/Python slot-layout drift? "
            "(run bin/hetucheck)")
    return {name: int(vals[i]) for i, name in enumerate(fields)}
