"""Offline data-dir inspector.

Behavioral equivalent of reference tools/etcd-dump-logs: load the newest
snapshot (print its term/index/conf state), then replay the WAL from the
snapshot marker and print every entry — decoded Requests for normal
entries, decoded ConfChanges for configuration entries — plus the WAL
metadata (node/cluster IDs) and final HardState.

Usage: python -m etcd_tpu_torch.tools.dump_logs <data-dir>
"""
from __future__ import annotations

import json
import struct
import sys
from typing import Optional, Sequence

from etcd_tpu_torch import raftpb
from etcd_tpu_torch.raftpb import ConfChangeType, EntryType
from etcd_tpu_torch.server.request import Request
from etcd_tpu_torch.snap import Snapshotter
from etcd_tpu_torch.wal import WAL, WalSnapshot


def _describe_entry(e) -> str:
    if e.type == EntryType.CONF_CHANGE:
        cc = raftpb.decode_conf_change(e.data)
        kind = ConfChangeType(cc.type).name
        ctx = ""
        if cc.context:
            try:
                ctx = " " + json.dumps(json.loads(cc.context.decode()))
            except (ValueError, UnicodeDecodeError):
                ctx = f" <{len(cc.context)}B context>"
        return (f"{e.term}\t{e.index}\tconf\t{kind} "
                f"{cc.node_id:x}{ctx}")
    if not e.data:
        return f"{e.term}\t{e.index}\tnorm\t<empty>"
    try:
        r = Request.decode(e.data)
        detail = f"{r.method} {r.path}"
        if r.val:
            v = r.val if len(r.val) <= 32 else r.val[:29] + "..."
            detail += f" val={v!r}"
        if r.prev_exist is not None:
            detail += f" prevExist={r.prev_exist}"
        return f"{e.term}\t{e.index}\tnorm\t{detail}"
    except Exception:
        return f"{e.term}\t{e.index}\tnorm\t<{len(e.data)}B undecodable>"


def dump(data_dir: str, out=sys.stdout) -> int:
    import os
    snapdir = os.path.join(data_dir, "member", "snap")
    waldir = os.path.join(data_dir, "member", "wal")
    if not os.path.isdir(waldir):
        print(f"no member/wal under {data_dir}", file=sys.stderr)
        return 1

    walsnap = WalSnapshot()
    if os.path.isdir(snapdir):
        snap = Snapshotter(snapdir).load_or_none()
        if snap is not None:
            md = snap.metadata
            walsnap = WalSnapshot(index=md.index, term=md.term)
            print(f"Snapshot:\nterm={md.term} index={md.index} nodes="
                  f"{[f'{n:x}' for n in md.conf_state.nodes]}", file=out)
        else:
            print("Snapshot:\nempty", file=out)

    print("Start dumping log entries from snapshot.", file=out)
    w = WAL.open(waldir, walsnap, write=False)
    try:
        metadata, state, ents = w.read_all()
    finally:
        w.close()
    try:
        md = json.loads(metadata.decode())
        print(f"WAL metadata:\nnodeID={md['id']} clusterID="
              f"{md['clusterId']}", file=out)
    except (ValueError, KeyError):
        print(f"WAL metadata: <{len(metadata)}B>", file=out)
    print(f"WAL entries: {len(ents)}", file=out)
    if ents:
        print(f"lastIndex={ents[-1].index}", file=out)
    print("term\tindex\ttype\tdata", file=out)
    for e in ents:
        print(_describe_entry(e), file=out)
    print(f"HardState: term={state.term} vote={state.vote:x} "
          f"commit={state.commit}", file=out)
    return 0


def dump_engine(data_dir: str, out=sys.stdout) -> int:
    """Inspect a MultiEngine data dir: newest checkpoint summary + every
    WAL round record (HardState/ring delta counts, admitted entries with
    decoded payloads, membership flips)."""
    from etcd_tpu_torch.server.engine import P_CONF, P_REQ
    from etcd_tpu_torch.server.engine import P_MULTI, _unpack_multi
    from etcd_tpu_torch.server.enginewal import CONF_ADD, EngineWAL

    w = EngineWAL(data_dir, fsync=False)
    ckpt_round, ckpt = w.load_checkpoint()
    if ckpt is not None:
        print(f"Checkpoint: round={ckpt_round} stores="
              f"{len(ckpt.get('stores', {}))} "
              f"pending_payloads={len(ckpt.get('payloads', []))}", file=out)
    else:
        print("Checkpoint: none", file=out)
    print("round\ths\tlast\tring\tentries/confs", file=out)
    n = 0
    for rec in w.replay(after_round=ckpt_round):
        n += 1
        detail = []
        for g, i, t, payload in rec.entries:
            kind = "?"
            body = ""
            if payload[:1] == bytes([P_REQ]):
                try:
                    r = Request.decode(payload[1:])
                    kind, body = "req", f"{r.method} {r.path}"
                except ValueError:
                    kind = "req<bad>"
            elif payload[:1] == bytes([P_CONF]):
                kind, body = "conf", payload[1:].decode(errors="replace")
            elif payload[:1] == bytes([P_MULTI]):
                # A batched entry (coalesced writes): each of its
                # Requests, in order.
                try:
                    rs = [Request.decode(b) for b in _unpack_multi(payload)]
                    kind = f"multi[{len(rs)}]"
                    body = ", ".join(f"{r.method} {r.path}" for r in rs)
                except (ValueError, struct.error):
                    kind = "multi<bad>"
            detail.append(f"g{g}@{i}.t{t} {kind} {body}".rstrip())
        for g, slot, op in rec.confs:
            detail.append(f"g{g} slot{slot} "
                          f"{'ADD' if op == CONF_ADD else 'REMOVE'}")
        print(f"{rec.round_no}\t{len(rec.hs_g)}\t{len(rec.last_g)}\t"
              f"{len(rec.ring_g)}\t{'; '.join(detail)}", file=out)
    print(f"{n} round records after checkpoint", file=out)
    return 0


def dump_v3(data_dir: str, out=sys.stdout) -> int:
    """Inspect a member's v3 backend: consistent index, revision span,
    live keys, leases (server/v3.py layout)."""
    import os
    import struct

    from etcd_tpu_torch.server.v3 import (CONSISTENT_INDEX_KEY, LEASE_BUCKET,
                                    V3Applier, b64d)

    path = os.path.join(data_dir, "member", "v3", "kv.db")
    if not os.path.isfile(path):
        print(f"no member/v3/kv.db under {data_dir}", file=sys.stderr)
        return 1
    a = V3Applier(path)
    try:
        kv = a.kv
        print(f"consistentIndex={a.consistent_index}", file=out)
        print(f"currentRev={kv.current_rev.main} "
              f"compactedRev={kv.compact_main_rev}", file=out)
        kvs, rev = kv.range(b"", b"\x00")   # whole keyspace
        print(f"live keys at rev {rev}: {len(kvs)}", file=out)
        print("key\tcreate\tmod\tver\tbytes", file=out)
        for item in kvs:
            print(f"{item.key.decode(errors='replace')}\t"
                  f"{item.create_rev}\t{item.mod_rev}\t{item.version}\t"
                  f"{len(item.value)}", file=out)
        print(f"leases: {len(a.leases)}", file=out)
        for lid, rec in sorted(a.leases.items()):
            keys = [b64d(k).decode(errors="replace") for k in rec["keys"]]
            print(f"lease {lid:x}: ttl={rec['ttl']} seq={rec['seq']} "
                  f"keys={keys}", file=out)
    finally:
        a.close()
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("--engine", "--v3"):
        if len(argv) != 2:
            print(f"usage: python -m etcd_tpu_torch.tools.dump_logs {argv[0]} "
                  "<dir>", file=sys.stderr)
            return 2
        return (dump_engine if argv[0] == "--engine" else dump_v3)(argv[1])
    if len(argv) != 1:
        print("usage: python -m etcd_tpu_torch.tools.dump_logs [--engine|--v3] "
              "<data-dir>", file=sys.stderr)
        return 2
    return dump(argv[0])


if __name__ == "__main__":
    sys.exit(main())
