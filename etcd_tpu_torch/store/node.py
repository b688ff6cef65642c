"""Internal tree node of the v2 store (reference store/node.go:39-).

A node is either a file (value, no children) or a dir (children, no value).
Hidden nodes — last path component starting with "_" — are excluded from
dir listings but fully addressable directly.
"""
from __future__ import annotations

import posixpath
from typing import Callable, Dict, List, Optional

from etcd_tpu_torch import errors
from etcd_tpu_torch.store.event import NodeExtern, ttl_of


def key_name(path: str) -> str:
    return posixpath.basename(path.rstrip("/")) or "/"


def is_hidden_name(name: str) -> bool:
    return name.startswith("_")


class Node:
    __slots__ = ("path", "created_index", "modified_index", "parent", "value",
                 "children", "expire_time")

    def __init__(self, path: str, created_index: int, modified_index: int,
                 parent: Optional["Node"], value: Optional[str] = None,
                 is_dir: bool = False,
                 expire_time: Optional[float] = None) -> None:
        self.path = path
        self.created_index = created_index
        self.modified_index = modified_index
        self.parent = parent
        self.value = value if not is_dir else None
        self.children: Optional[Dict[str, "Node"]] = {} if is_dir else None
        self.expire_time = expire_time

    @property
    def is_dir(self) -> bool:
        return self.children is not None

    @property
    def is_permanent(self) -> bool:
        return self.expire_time is None

    @property
    def name(self) -> str:
        return key_name(self.path)

    def is_hidden(self) -> bool:
        return is_hidden_name(self.name)

    # -- file ops ------------------------------------------------------------

    def read(self) -> str:
        if self.is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_FILE, cause=self.path)
        return self.value or ""

    def write(self, value: str, index: int) -> None:
        if self.is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_FILE, cause=self.path)
        self.value = value
        self.modified_index = index

    # -- dir ops -------------------------------------------------------------

    def get_child(self, name: str) -> Optional["Node"]:
        if not self.is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_DIR, cause=self.path)
        return self.children.get(name)

    def add(self, child: "Node") -> None:
        if not self.is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_DIR, cause=self.path)
        name = child.name
        if name in self.children:
            raise errors.EtcdError(errors.ECODE_NODE_EXIST, cause=child.path)
        self.children[name] = child

    def list_children(self) -> List["Node"]:
        if not self.is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_FILE, cause=self.path)
        return list(self.children.values())

    def remove(self, is_dir: bool, recursive: bool,
               callback: Optional[Callable[[str], None]] = None) -> None:
        """Detach this node from its parent (reference node.go Remove):
        files remove directly; dirs require dir=True, and non-empty dirs
        require recursive=True."""
        if not self.is_dir:
            self._detach(callback)
            return
        if not is_dir:
            raise errors.EtcdError(errors.ECODE_NOT_FILE, cause=self.path)
        if not recursive and self.children:
            raise errors.EtcdError(errors.ECODE_DIR_NOT_EMPTY, cause=self.path)
        for child in list(self.children.values()):
            child.remove(True, True, callback)
        self._detach(callback)

    def _detach(self, callback: Optional[Callable[[str], None]]) -> None:
        if callback is not None:
            callback(self.path)
        if self.parent is not None and self.parent.children is not None:
            self.parent.children.pop(self.name, None)
        self.parent = None

    # -- external view -------------------------------------------------------

    def as_extern(self, now: float, recursive: bool = False,
                  want_sorted: bool = False,
                  materialize_children: bool = True) -> NodeExtern:
        ex = NodeExtern(
            key=self.path,
            dir=self.is_dir,
            created_index=self.created_index,
            modified_index=self.modified_index,
            expiration=self.expire_time,
            ttl=ttl_of(self.expire_time, now),
        )
        if not self.is_dir:
            ex.value = self.value or ""
            return ex
        if materialize_children:
            kids = [c for c in self.children.values() if not c.is_hidden()]
            if want_sorted:
                kids.sort(key=lambda n: n.path)
            ex.nodes = [
                c.as_extern(now, recursive, want_sorted,
                            materialize_children=recursive)
                for c in kids
            ]
        return ex

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> dict:
        d: dict = {
            "path": self.path,
            "createdIndex": self.created_index,
            "modifiedIndex": self.modified_index,
        }
        if self.expire_time is not None:
            d["expireTime"] = self.expire_time
        if self.is_dir:
            d["dir"] = True
            d["children"] = [c.to_json() for c in self.children.values()]
        else:
            d["value"] = self.value or ""
        return d

    @staticmethod
    def from_json(d: dict, parent: Optional["Node"]) -> "Node":
        n = Node(
            path=d["path"],
            created_index=d["createdIndex"],
            modified_index=d["modifiedIndex"],
            parent=parent,
            value=d.get("value"),
            is_dir=bool(d.get("dir")),
            expire_time=d.get("expireTime"),
        )
        if n.is_dir:
            for cd in d.get("children", []):
                c = Node.from_json(cd, n)
                n.children[c.name] = c
        return n

    def clone(self, parent: Optional["Node"] = None) -> "Node":
        n = Node(self.path, self.created_index, self.modified_index, parent,
                 self.value, self.is_dir, self.expire_time)
        if self.is_dir:
            for name, c in self.children.items():
                n.children[name] = c.clone(n)
        return n
