"""Offline v0.4 -> v2 data-dir converter (reference migrate/:
etcd4.go:55-145 Migrate4To2, log.go:75-129 log decode + 11 command
conversions, snapshot.go Snapshot4/Store4, config.go Config4, member.go
NewMember id hashing).

v0.4 on-disk layout (all formats reproduced here exactly):
    <dir>/log           entries framed as "%8x\n"-length + protobuf
                        LogEntry{1:index u64, 2:term u64, 3:command_name
                        string, 4:command bytes(JSON)}
    <dir>/conf          JSON {"commitIndex": N, "peers": [...]}
    <dir>/snapshot/     "<lastIndex>_<lastTerm>.ss" JSON {state(b64),
                        lastIndex, lastTerm, peers}

Output: this framework's v2 member layout — member/wal (our WAL format,
JSON metadata {"id","clusterId"}) + member/snap — ready for EtcdServer's
restart path. Terms are shifted by +1 (reference termOffset4to2,
etcd4.go:33) so post-migration terms never collide with v0.4 ones.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import struct
from dataclasses import dataclass, field
from datetime import datetime, timezone
from typing import Dict, List, Optional, Tuple

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import (ConfChange, ConfChangeType, ConfState, Entry,
                             EntryType, HardState, Snapshot,
                             SnapshotMetadata)
from etcd_tpu_torch.server.cluster import Member, member_store_key
from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.snap import Snapshotter
from etcd_tpu_torch.store import Store
from etcd_tpu_torch.utils.fileutil import touch_dir_all
from etcd_tpu_torch.wal import WAL, WalSnapshot

log = logging.getLogger("etcd_tpu.migrate")

TERM_OFFSET_4_TO_2 = 1          # reference etcd4.go:33
MIGRATED_CLUSTER_ID = 0x04ADD5  # reference etcd4.go:85


# ---------------------------------------------------------------------------
# v0.4 log decoding
# ---------------------------------------------------------------------------

@dataclass
class LogEntry4:
    index: int
    term: int
    command_name: str
    command: bytes


def _read_varint(b: bytes, off: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        x = b[off]
        off += 1
        out |= (x & 0x7F) << shift
        if not x & 0x80:
            return out, off
        shift += 7


def _decode_log_entry_pb(b: bytes) -> LogEntry4:
    """Minimal protobuf decode of etcd4pb.LogEntry (log_entry.proto)."""
    index = term = 0
    name = ""
    command = b""
    off = 0
    while off < len(b):
        tag, off = _read_varint(b, off)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, off = _read_varint(b, off)
            if fnum == 1:
                index = val
            elif fnum == 2:
                term = val
        elif wtype == 2:
            ln, off = _read_varint(b, off)
            data = b[off:off + ln]
            off += ln
            if fnum == 3:
                name = data.decode()
            elif fnum == 4:
                command = data
        else:
            raise ValueError(f"unsupported wire type {wtype} in v0.4 entry")
    return LogEntry4(index, term, name, command)


def encode_log_entry4(e: LogEntry4) -> bytes:
    """Inverse of the decoder — used by tests and etcd-dump-logs fixtures."""
    def varint(v):
        out = b""
        while True:
            x = v & 0x7F
            v >>= 7
            if v:
                out += bytes([x | 0x80])
            else:
                return out + bytes([x])

    body = (bytes([1 << 3]) + varint(e.index)
            + bytes([2 << 3]) + varint(e.term)
            + bytes([(3 << 3) | 2]) + varint(len(e.command_name))
            + e.command_name.encode())
    if e.command:
        body += bytes([(4 << 3) | 2]) + varint(len(e.command)) + e.command
    return f"{len(body):08x}\n".encode() + body


def decode_log4(path: str) -> List[LogEntry4]:
    """reference DecodeLog4/DecodeNextEntry4 (log.go:110-129): '%8x\\n'
    length prefix then the protobuf body, until EOF."""
    out: List[LogEntry4] = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(9)
            if not hdr:
                break
            if len(hdr) != 9 or hdr[8:9] != b"\n":
                raise ValueError(f"corrupt v0.4 log framing at entry "
                                 f"{len(out)}")
            ln = int(hdr[:8], 16)
            body = f.read(ln)
            if len(body) != ln:
                raise ValueError("truncated v0.4 log entry")
            out.append(_decode_log_entry_pb(body))
    return out


# ---------------------------------------------------------------------------
# v0.4 config + snapshot
# ---------------------------------------------------------------------------

def decode_config4(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def decode_latest_snapshot4(snapdir: str) -> Optional[dict]:
    """Newest '<index>_<term>.ss' file (reference FindLatestFile
    snapshot.go:260-287: numeric sort on the index prefix)."""
    if not os.path.isdir(snapdir):
        return None
    best = None
    for name in os.listdir(snapdir):
        if not name.endswith(".ss"):
            continue
        try:
            idx = int(name.split("_")[0])
        except ValueError:
            continue
        if best is None or idx > best[0]:
            best = (idx, name)
    if best is None:
        return None
    with open(os.path.join(snapdir, best[1])) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# command conversion (reference log.go:139-455)
# ---------------------------------------------------------------------------

def _store_path(key: str) -> str:
    return "/1/" + key.strip("/") if key.strip("/") else "/1"


_PERMANENT = ("0001-01-01T00:00:00Z", "")


def _expiration(expire_time) -> Optional[float]:
    """v0.4 JSON time.Time -> absolute unix seconds; zero time = permanent
    (reference UnixTimeOrPermanent log.go:36-42)."""
    if not expire_time or expire_time in _PERMANENT:
        return None
    ts = expire_time.replace("Z", "+00:00")
    # Go emits nanosecond fractions; Python wants <= microseconds.
    if "." in ts:
        head, frac = ts.split(".", 1)
        tz = ""
        for sep in ("+", "-"):
            if sep in frac:
                frac, tz = frac.split(sep, 1)
                tz = sep + tz
                break
        ts = f"{head}.{frac[:6]}{tz}"
    dt = datetime.fromisoformat(ts)
    if dt.timestamp() <= 0:
        return None
    return dt.timestamp()


def _member_from_join(d: dict, cluster_name: str = "etcd-cluster") -> Member:
    """reference generateNodeMember: id = sha1(sorted peer urls + cluster
    name) — reproduced via our Member.new (same scheme)."""
    return Member.new(d.get("name", ""), [d.get("raftURL", "")],
                      [d.get("etcdURL", "")] if d.get("etcdURL") else (),
                      cluster_token=cluster_name)


def convert_entry(e: LogEntry4, raft_map: Dict[str, int]) -> Entry:
    """One v0.4 command -> one v2 entry (reference toEntry2 + the Command4
    implementations, log.go:144-455)."""
    name = e.command_name
    d = json.loads(e.command.decode()) if e.command else {}
    etype = EntryType.NORMAL
    data = b""

    if name == "etcd:join":
        m = _member_from_join(d)
        raft_map[d.get("name", "")] = m.id
        cc = ConfChange(type=ConfChangeType.ADD_NODE, node_id=m.id,
                        context=json.dumps(m.to_dict()).encode())
        etype, data = EntryType.CONF_CHANGE, raftpb.encode_conf_change(cc)
    elif name == "etcd:remove":
        mid = raft_map.pop(d.get("name", ""), None)
        if mid is None:
            raise ValueError(
                f"removing node {d.get('name')!r} before it joined")
        cc = ConfChange(type=ConfChangeType.REMOVE_NODE, node_id=mid)
        etype, data = EntryType.CONF_CHANGE, raftpb.encode_conf_change(cc)
    elif name == "etcd:set":
        data = Request(method="PUT", path=_store_path(d["key"]),
                       val=d.get("value", ""), dir=d.get("dir", False),
                       expiration=_expiration(d.get("expireTime"))).encode()
    elif name == "etcd:create":
        if d.get("unique"):
            data = Request(method="POST", path=_store_path(d["key"]),
                           val=d.get("value", ""), dir=d.get("dir", False),
                           expiration=_expiration(d.get("expireTime"))
                           ).encode()
        else:
            data = Request(method="PUT", path=_store_path(d["key"]),
                           val=d.get("value", ""), dir=d.get("dir", False),
                           prev_exist=True,
                           expiration=_expiration(d.get("expireTime"))
                           ).encode()
    elif name == "etcd:update":
        data = Request(method="PUT", path=_store_path(d["key"]),
                       val=d.get("value", ""), prev_exist=True,
                       expiration=_expiration(d.get("expireTime"))).encode()
    elif name == "etcd:compareAndSwap":
        data = Request(method="PUT", path=_store_path(d["key"]),
                       val=d.get("value", ""),
                       prev_value=d.get("prevValue", ""),
                       prev_index=d.get("prevIndex", 0),
                       expiration=_expiration(d.get("expireTime"))).encode()
    elif name == "etcd:delete":
        data = Request(method="DELETE", path=_store_path(d["key"]),
                       dir=d.get("dir", False),
                       recursive=d.get("recursive", False)).encode()
    elif name == "etcd:compareAndDelete":
        data = Request(method="DELETE", path=_store_path(d["key"]),
                       prev_value=d.get("prevValue", ""),
                       prev_index=d.get("prevIndex", 0)).encode()
    elif name == "etcd:sync":
        t = _expiration(d.get("time")) or 0.0
        data = Request(method="SYNC", time=t).encode()
    elif name == "etcd:setClusterConfig":
        data = Request(method="PUT", path="/v2/admin/config",
                       val=json.dumps(d.get("config") or {})).encode()
    elif name == "raft:nop":
        data = b""
    elif name in ("raft:join", "raft:leave"):
        raise ValueError(
            "found a raft join/leave command; these shouldn't be in an "
            "etcd log")
    else:
        raise ValueError(f"unregistered command type {name}")

    return Entry(type=etype, term=e.term + TERM_OFFSET_4_TO_2,
                 index=e.index, data=data)


# ---------------------------------------------------------------------------
# snapshot conversion (reference snapshot.go Snapshot2)
# ---------------------------------------------------------------------------

def _walk_node4(store: Store, n: dict) -> None:
    """Replay a v0.4 store node tree into our Store under /1 (keyspace
    only; the _etcd machine registry becomes ConfState/membership).
    A v0.4 node is a directory iff Children is non-null (Go map != nil)."""
    path = n.get("Path", "/")
    if path.lstrip("/").startswith("_etcd"):
        return
    children = n.get("Children")
    if path not in ("/", ""):
        target = _store_path(path)
        if children is not None:
            if not children:
                store.set(target, is_dir=True)   # empty dir needs a node
        else:
            store.set(target, value=n.get("Value", ""),
                      expire_time=_expiration(n.get("ExpireTime")))
    for c in (children or {}).values():
        _walk_node4(store, c)


def machines_from_snapshot4(snap4: dict) -> Dict[str, Member]:
    """Membership from /_etcd/machines (reference pullNodesFromEtcd):
    each machine's value is a query string "raft=...&etcd=..."."""
    from urllib.parse import parse_qs
    state = json.loads(base64.b64decode(snap4["state"]))
    root = state.get("Root") or {}
    machines = (root.get("Children") or {}).get("_etcd", {})
    machines = (machines.get("Children") or {}).get("machines", {})
    out: Dict[str, Member] = {}
    for name, c in (machines.get("Children") or {}).items():
        q = parse_qs(c.get("Value", ""))
        short = name.rsplit("/", 1)[-1]
        out[short] = _member_from_join({
            "name": short,
            "raftURL": (q.get("raft") or [""])[0],
            "etcdURL": (q.get("etcd") or [""])[0]})
    return out


def snapshot4_to_2(snap4: dict) -> Snapshot:
    state = json.loads(base64.b64decode(snap4["state"]))
    root = state.get("Root") or {}
    store = Store()
    _walk_node4(store, root)

    members = machines_from_snapshot4(snap4)
    for m in members.values():
        store.set(member_store_key(m.id) + "/raftAttributes",
                  value=m.raft_attributes_json())

    return Snapshot(
        data=store.save(),
        metadata=SnapshotMetadata(
            index=snap4["lastIndex"],
            term=snap4["lastTerm"] + TERM_OFFSET_4_TO_2,
            conf_state=ConfState(
                nodes=tuple(sorted(m.id for m in members.values())))))


# ---------------------------------------------------------------------------
# the driver (reference Migrate4To2 etcd4.go:55-145)
# ---------------------------------------------------------------------------

def is_v04_data_dir(data_dir: str) -> bool:
    """v0.4 layout detection (reference version.DetectDataDir sniffing,
    version/version.go:35-88): top-level `log` + `conf`."""
    return (os.path.isfile(os.path.join(data_dir, "log"))
            and os.path.isfile(os.path.join(data_dir, "conf")))


def migrate_4_to_2(data_dir: str, name: str) -> None:
    snap4 = decode_latest_snapshot4(os.path.join(data_dir, "snapshot"))
    cfg4 = decode_config4(os.path.join(data_dir, "conf"))
    ents4 = decode_log4(os.path.join(data_dir, "log"))

    # Monotonic index check (reference Entries4To2:465-473).
    for i, e in enumerate(ents4[1:]):
        if e.index != ents4[0].index + i + 1:
            raise ValueError(f"skipped log index {ents4[0].index + i + 1}")

    # The node's id can come from its join entry in the live log OR from
    # the snapshot's machine registry — a log compacted past cluster
    # formation only has the latter (reference GuessNodeID etcd4.go:77-83
    # consults snapshot, log and config in turn).
    raft_map: Dict[str, int] = {}
    if snap4 is not None:
        raft_map.update({nm: m.id
                         for nm, m in machines_from_snapshot4(snap4).items()})
    ents2 = [convert_entry(e, raft_map) for e in ents4]
    if not ents2 and snap4 is None:
        raise ValueError("nothing to migrate: empty v0.4 log, no snapshot")

    snap2 = snapshot4_to_2(snap4) if snap4 is not None else None
    node_id = raft_map.get(name, 0)
    if node_id == 0:
        raise ValueError(
            f"couldn't find node {name!r} in the v0.4 log or snapshot, "
            f"cannot convert")

    commit = cfg4.get("commitIndex", 0)
    term = (ents2[-1].term if ents2 else snap2.metadata.term)
    if snap2 is not None:
        commit = max(commit, snap2.metadata.index)
    hs = HardState(term=term, vote=0, commit=commit)

    member_dir = os.path.join(data_dir, "member")
    touch_dir_all(os.path.join(member_dir, "snap"))
    metadata = json.dumps({"id": f"{node_id:x}",
                           "clusterId": f"{MIGRATED_CLUSTER_ID:x}"}).encode()
    w = WAL.create(os.path.join(member_dir, "wal"), metadata)
    try:
        walsnap = WalSnapshot()
        if snap2 is not None:
            walsnap = WalSnapshot(index=snap2.metadata.index,
                                  term=snap2.metadata.term)
            Snapshotter(os.path.join(member_dir, "snap")).save_snap(snap2)
            w.save_snapshot(walsnap)
            ents2 = [e for e in ents2 if e.index > walsnap.index]
        w.save(hs, ents2)
    finally:
        w.close()
    log.info("migrated v0.4 dir %s: %d entries, snapshot=%s, node=%x",
             data_dir, len(ents2), snap4 is not None, node_id)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Migrate an etcd v0.4 data directory to the v2 layout")
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--name", required=True,
                    help="this member's v0.4 node name")
    args = ap.parse_args(argv)
    migrate_4_to_2(args.data_dir, args.name)
    print(f"migration of {args.data_dir} successful")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
