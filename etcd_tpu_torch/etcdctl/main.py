"""etcdctl command set.

Behavioral equivalent of reference etcdctl/main.go + etcdctl/command/*.go:
ls/mk/mkdir/rm/rmdir/get/set/setdir/update/updatedir/watch/exec-watch,
member list|add|remove, cluster-health, backup (disaster-recovery WAL copy
with fresh node identity, backup_command.go:33-) and import. Peers come
from --peers / ETCDCTL_PEERS; output shapes follow the reference commands.

Beyond the reference: `v3 put|get|del|compact|txn` drive the served v3 KV
preview (/v3/kv gateway; the reference ships only the RFC).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from etcd_tpu_torch.client import Client, KeysAPI, KeysError, MembersAPI
from etcd_tpu_torch.client.client import ClientError

DEFAULT_PEERS = "http://127.0.0.1:4001,http://127.0.0.1:2379"


def _client(args) -> Client:
    peers = (args.peers or os.environ.get("ETCDCTL_PEERS") or
             DEFAULT_PEERS).split(",")
    return Client([p.strip() for p in peers if p.strip()],
                  timeout=args.timeout,
                  username=(args.username or "").split(":")[0],
                  password=(args.username.split(":", 1)[1]
                            if args.username and ":" in args.username
                            else ""))


def _keys(args) -> KeysAPI:
    return KeysAPI(_client(args))


def _die(msg: str, code: int = 1) -> int:
    print(f"Error: {msg}", file=sys.stderr)
    return code


# -- v3 commands (the served v3 preview; reference ships only the RFC) -------

def _v3_call(args, path: str, body: dict):
    """POST one v3 op through the shared Client (endpoint failover, 5xx
    rotation and Basic auth all come from Client.do — one code path with
    the v2 commands)."""
    resp = _client(args).do("POST", f"/v3/kv/{path}",
                            json.dumps(body).encode(),
                            headers={"Content-Type": "application/json"})
    try:
        parsed = json.loads(resp.body) if resp.body else None
    except json.JSONDecodeError:
        parsed = None
    if not isinstance(parsed, dict):
        # Non-gateway answer (v2-only member, proxy error page): a clean
        # CLI error, not a traceback.
        parsed = {"error": (resp.body or b"").decode(errors="replace")
                  [:200] or f"HTTP {resp.status}", "code": 13}
    return resp.status, parsed


def _b64s(s: str) -> str:
    import base64 as _b64
    return _b64.b64encode(s.encode()).decode()


def _b64d(s: str) -> str:
    import base64 as _b64
    return _b64.b64decode(s).decode(errors="replace")


def _prefix_end_b64(key: str) -> str:
    """base64 of the smallest byte string greater than every key with this
    prefix. Computed on RAW bytes and base64'd directly — a bytes->str
    round-trip would mangle the (often invalid-UTF-8) end bytes and make
    --prefix match/delete keys OUTSIDE the prefix."""
    import base64 as _b64
    b = bytearray(key.encode())
    for i in range(len(b) - 1, -1, -1):
        if b[i] < 0xFF:
            b[i] += 1
            return _b64.b64encode(bytes(b[:i + 1])).decode()
    return _b64.b64encode(b"\x00").decode()   # whole keyspace


def cmd_v3_put(args) -> int:
    st, b = _v3_call(args, "put", {"key": _b64s(args.key),
                                   "value": _b64s(args.value)})
    if st != 200:
        return _die(b.get("error", str(b)))
    print("OK")
    return 0


def cmd_v3_get(args) -> int:
    body = {"key": _b64s(args.key)}
    if args.prefix:
        body["range_end"] = _prefix_end_b64(args.key)
    if args.rev:
        body["revision"] = args.rev
    if args.limit:
        body["limit"] = args.limit
    if args.serializable:
        body["serializable"] = True
    st, b = _v3_call(args, "range", body)
    if st != 200:
        return _die(b.get("error", str(b)))
    for kv in b.get("kvs", []):
        print(_b64d(kv["key"]))
        print(_b64d(kv["value"]))
    return 0


def cmd_v3_del(args) -> int:
    body = {"key": _b64s(args.key)}
    if args.prefix:
        body["range_end"] = _prefix_end_b64(args.key)
    st, b = _v3_call(args, "deleterange", body)
    if st != 200:
        return _die(b.get("error", str(b)))
    print(b.get("deleted", 0))
    return 0


def cmd_v3_compact(args) -> int:
    st, b = _v3_call(args, "compact", {"revision": args.revision})
    if st != 200:
        return _die(b.get("error", str(b)))
    print(f"compacted revision {args.revision}")
    return 0


def cmd_v3_txn(args) -> int:
    """Reads a TxnRequest as JSON from stdin (compare/success/failure with
    base64 bytes fields, the gateway encoding) and prints the response."""
    try:
        body = json.loads(sys.stdin.read() or "{}")
    except json.JSONDecodeError as e:
        return _die(f"bad txn JSON on stdin: {e}")
    st, b = _v3_call(args, "txn", body)
    print(json.dumps(b, indent=2))
    return 0 if st == 200 else 1


# -- key commands (reference etcdctl/command/*_command.go) -------------------

def cmd_get(args) -> int:
    try:
        r = _keys(args).get(args.key, sorted=args.sort,
                            quorum=args.quorum)
    except KeysError as e:
        return _die(e.message if e.code else str(e))
    if r.node.dir:
        return _die(f"{args.key}: is a directory")
    print(r.node.value)
    return 0


def cmd_set(args) -> int:
    try:
        r = _keys(args).set(args.key, args.value, ttl=args.ttl,
                            prev_value=args.swap_with_value or "",
                            prev_index=args.swap_with_index)
    except KeysError as e:
        return _die(e.message)
    print(r.node.value)
    return 0


def cmd_mk(args) -> int:
    try:
        r = _keys(args).create(args.key, args.value, ttl=args.ttl)
    except KeysError as e:
        return _die(e.message)
    print(r.node.value)
    return 0


def cmd_mkdir(args) -> int:
    try:
        _keys(args).set(args.key, dir=True, ttl=args.ttl, prev_exist=False)
    except KeysError as e:
        return _die(e.message)
    return 0


def cmd_setdir(args) -> int:
    try:
        _keys(args).set(args.key, dir=True, ttl=args.ttl)
    except KeysError as e:
        return _die(e.message)
    return 0


def cmd_update(args) -> int:
    try:
        r = _keys(args).update(args.key, args.value, ttl=args.ttl)
    except KeysError as e:
        return _die(e.message)
    print(r.node.value)
    return 0


def cmd_updatedir(args) -> int:
    try:
        _keys(args).set(args.key, dir=True, ttl=args.ttl, prev_exist=True)
    except KeysError as e:
        return _die(e.message)
    return 0


def cmd_rm(args) -> int:
    try:
        if args.recursive:
            _keys(args).delete(args.key, recursive=True)
        elif args.dir:
            _keys(args).delete(args.key, dir=True)
        else:
            _keys(args).delete(args.key,
                               prev_value=args.with_value or "",
                               prev_index=args.with_index)
    except KeysError as e:
        return _die(e.message)
    return 0


def cmd_rmdir(args) -> int:
    try:
        _keys(args).delete(args.key, dir=True)
    except KeysError as e:
        return _die(e.message)
    return 0


def cmd_ls(args) -> int:
    try:
        r = _keys(args).get(args.key, recursive=args.recursive,
                            sorted=args.sort)
    except KeysError as e:
        return _die(e.message)

    def walk(node, depth=0):
        for n in node.nodes:
            suffix = "/" if n.dir else ""
            if args.p and n.dir:
                print(n.key + "/")
            else:
                print(n.key + (suffix if args.p else ""))
            if args.recursive and n.dir:
                walk(n, depth + 1)

    if r.node.dir:
        walk(r.node)
    else:
        print(r.node.key)
    return 0


def cmd_watch(args) -> int:
    k = _keys(args)
    w = k.watcher(args.key, after_index=args.after_index,
                  recursive=args.recursive)
    try:
        while True:
            r = w.next()
            print(r.node.value if r.node and r.node.value is not None
                  else "")
            if not args.forever:
                return 0
    except KeyboardInterrupt:
        return 0


def cmd_exec_watch(args) -> int:
    k = _keys(args)
    w = k.watcher(args.key, recursive=args.recursive)
    cmdline = args.cmd
    try:
        while True:
            r = w.next()
            env = dict(os.environ)
            env["ETCD_WATCH_ACTION"] = r.action
            env["ETCD_WATCH_KEY"] = r.node.key if r.node else ""
            env["ETCD_WATCH_VALUE"] = (r.node.value or ""
                                       if r.node else "")
            env["ETCD_WATCH_MODIFIED_INDEX"] = str(
                r.node.modified_index if r.node else 0)
            subprocess.call(cmdline, env=env)
    except KeyboardInterrupt:
        return 0


# -- member commands ---------------------------------------------------------

def cmd_member_list(args) -> int:
    for m in MembersAPI(_client(args)).list():
        print(f"{m.id}: name={m.name} peerURLs={','.join(m.peer_urls)} "
              f"clientURLs={','.join(m.client_urls)}")
    return 0


def cmd_member_add(args) -> int:
    mapi = MembersAPI(_client(args))
    m = mapi.add(args.peer_urls.split(","))
    print(f"Added member named {args.name} with ID {m.id} to cluster")
    existing = mapi.list()
    names = [f"{x.name or args.name}={u}"
             for x in existing for u in x.peer_urls]
    print(f'ETCD_NAME="{args.name}"')
    print(f'ETCD_INITIAL_CLUSTER="{",".join(names)}"')
    print('ETCD_INITIAL_CLUSTER_STATE="existing"')
    return 0


def cmd_member_remove(args) -> int:
    MembersAPI(_client(args)).remove(args.member_id)
    print(f"Removed member {args.member_id} from cluster")
    return 0


def cmd_cluster_health(args) -> int:
    """reference etcdctl/command/cluster_health.go: per-member /health."""
    import urllib.request
    c = _client(args)
    try:
        members = MembersAPI(c).list()
    except ClientError as e:
        print("cluster may be unhealthy: failed to list members")
        return _die(str(e))
    unhealthy = 0
    for m in members:
        ok = False
        for u in m.client_urls:
            try:
                with urllib.request.urlopen(u.rstrip("/") + "/health",
                                            timeout=args.timeout) as resp:
                    ok = json.loads(resp.read()).get("health") == "true"
                    break
            except Exception:
                continue
        status = "healthy" if ok else "unhealthy"
        if not ok:
            unhealthy += 1
        print(f"member {m.id} is {status}: got {status} result from "
              f"{m.client_urls[0] if m.client_urls else '<none>'}")
    if unhealthy == 0:
        print("cluster is healthy")
        return 0
    print("cluster is degraded" if unhealthy < len(members)
          else "cluster is unavailable")
    return 5


# -- backup (reference etcdctl/command/backup_command.go:33-) ----------------

def cmd_backup(args) -> int:
    from etcd_tpu_torch import raftpb
    from etcd_tpu_torch.snap import Snapshotter
    from etcd_tpu_torch.utils.fileutil import touch_dir_all
    from etcd_tpu_torch.wal import WAL, WalSnapshot

    src_snap = os.path.join(args.data_dir, "member", "snap")
    src_wal = args.wal_dir or os.path.join(args.data_dir, "member", "wal")
    dst_snap = os.path.join(args.backup_dir, "member", "snap")
    dst_wal = (args.backup_wal_dir or
               os.path.join(args.backup_dir, "member", "wal"))

    touch_dir_all(dst_snap)
    ss = Snapshotter(src_snap)
    snap = ss.load_or_none()
    walsnap = WalSnapshot()
    if snap is not None:
        walsnap = WalSnapshot(index=snap.metadata.index,
                              term=snap.metadata.term)
        Snapshotter(dst_snap).save_snap(snap)

    # Read-only open: the source member may still be running and holding
    # its segment locks (reference uses wal.OpenNotInUse).
    with WAL.open(src_wal, walsnap, write=False) as w:
        metadata, hs, ents = w.read_all()
    # Strip the node identity so the restored member forms a NEW cluster
    # (reference backup_command.go rewrites metadata with fresh ids).
    md = json.loads(metadata.decode()) if metadata else {}
    md["id"] = "0"
    md["clusterId"] = "0"
    neww = WAL.create(dst_wal, json.dumps(md).encode())
    try:
        neww.save_snapshot(walsnap)
        neww.save(hs, list(ents))
    finally:
        neww.close()
    print(f"backup saved to {args.backup_dir} "
          f"({len(ents)} entries, snapshot "
          f"{'yes' if snap is not None else 'no'})")
    return 0


def cmd_import(args) -> int:
    """Bulk-load a JSON dump of key->value pairs (moral of
    import_snap_command.go without the legacy 0.4 snap format)."""
    k = _keys(args)
    with open(args.snap_file) as f:
        data = json.load(f)
    n = 0
    for key, value in data.items():
        k.set(key, value)
        n += 1
    print(f"imported {n} keys")
    return 0


# -- argument wiring ---------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="etcdctl", description="A simple command line client for etcd.")
    ap.add_argument("--peers", "-C", default=None,
                    help="comma-separated machine addresses")
    ap.add_argument("--timeout", type=float, default=2.0)
    ap.add_argument("--username", "-u", default=None,
                    help="user:password for auth")
    ap.add_argument("--debug", action="store_true")
    sub = ap.add_subparsers(dest="command", required=True)

    def add(name, fn, **kw):
        p = sub.add_parser(name, **kw)
        p.set_defaults(fn=fn)
        return p

    p = add("get", cmd_get)
    p.add_argument("key")
    p.add_argument("--sort", action="store_true")
    p.add_argument("--quorum", action="store_true")

    p = add("set", cmd_set)
    p.add_argument("key")
    p.add_argument("value")
    p.add_argument("--ttl", type=int, default=0)
    p.add_argument("--swap-with-value", default=None)
    p.add_argument("--swap-with-index", type=int, default=0)

    p = add("mk", cmd_mk)
    p.add_argument("key")
    p.add_argument("value")
    p.add_argument("--ttl", type=int, default=0)

    for name, fn in (("mkdir", cmd_mkdir), ("setdir", cmd_setdir),
                     ("updatedir", cmd_updatedir)):
        p = add(name, fn)
        p.add_argument("key")
        p.add_argument("--ttl", type=int, default=0)

    p = add("update", cmd_update)
    p.add_argument("key")
    p.add_argument("value")
    p.add_argument("--ttl", type=int, default=0)

    p = add("rm", cmd_rm)
    p.add_argument("key")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--dir", action="store_true")
    p.add_argument("--with-value", default=None)
    p.add_argument("--with-index", type=int, default=0)

    p = add("rmdir", cmd_rmdir)
    p.add_argument("key")

    p = add("ls", cmd_ls)
    p.add_argument("key", nargs="?", default="/")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--sort", action="store_true")
    p.add_argument("-p", action="store_true",
                   help="append / to directories")

    p = add("watch", cmd_watch)
    p.add_argument("key")
    p.add_argument("--forever", action="store_true")
    p.add_argument("--recursive", action="store_true")
    p.add_argument("--after-index", type=int, default=0)

    p = add("exec-watch", cmd_exec_watch)
    p.add_argument("key")
    p.add_argument("cmd", nargs=argparse.REMAINDER)
    p.add_argument("--recursive", action="store_true")

    pm = sub.add_parser("member")
    msub = pm.add_subparsers(dest="member_command", required=True)
    p = msub.add_parser("list")
    p.set_defaults(fn=cmd_member_list)
    p = msub.add_parser("add")
    p.add_argument("name")
    p.add_argument("peer_urls")
    p.set_defaults(fn=cmd_member_add)
    p = msub.add_parser("remove")
    p.add_argument("member_id")
    p.set_defaults(fn=cmd_member_remove)

    add("cluster-health", cmd_cluster_health)

    pv3 = sub.add_parser("v3", help="v3 KV preview (served /v3/kv gateway)")
    v3sub = pv3.add_subparsers(dest="v3_command", required=True)
    p = v3sub.add_parser("put")
    p.add_argument("key")
    p.add_argument("value")
    p.set_defaults(fn=cmd_v3_put)
    p = v3sub.add_parser("get")
    p.add_argument("key")
    p.add_argument("--prefix", action="store_true")
    p.add_argument("--rev", type=int, default=0)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--serializable", action="store_true")
    p.set_defaults(fn=cmd_v3_get)
    p = v3sub.add_parser("del")
    p.add_argument("key")
    p.add_argument("--prefix", action="store_true")
    p.set_defaults(fn=cmd_v3_del)
    p = v3sub.add_parser("compact")
    p.add_argument("revision", type=int)
    p.set_defaults(fn=cmd_v3_compact)
    p = v3sub.add_parser("txn", help="TxnRequest JSON on stdin")
    p.set_defaults(fn=cmd_v3_txn)

    p = add("backup", cmd_backup)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--wal-dir", default=None)
    p.add_argument("--backup-dir", required=True)
    p.add_argument("--backup-wal-dir", default=None)

    p = add("import", cmd_import)
    p.add_argument("--snap-file", required=True)

    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ClientError as e:
        return _die(str(e))


if __name__ == "__main__":
    sys.exit(main())
