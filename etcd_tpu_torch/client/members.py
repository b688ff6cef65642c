"""Typed membership API (reference client/members.go:96-105)."""
from __future__ import annotations

import json
from typing import List, Optional, Sequence

from etcd_tpu_torch.client.client import Client, ClientError

_JSON_HDR = {"Content-Type": "application/json"}


class MemberInfo:
    def __init__(self, d: dict) -> None:
        self.id = d.get("id", "")
        self.name = d.get("name", "")
        self.peer_urls = list(d.get("peerURLs") or [])
        self.client_urls = list(d.get("clientURLs") or [])

    def __repr__(self) -> str:
        return f"MemberInfo(id={self.id}, name={self.name!r})"


class MembersError(ClientError):
    def __init__(self, status: int, message: str) -> None:
        self.status = status
        self.message = message
        super().__init__(f"HTTP {status}: {message}")


class MembersAPI:
    def __init__(self, client: Client) -> None:
        self.client = client

    def list(self) -> List[MemberInfo]:
        resp = self.client.do("GET", "/v2/members")
        if resp.status != 200:
            raise MembersError(resp.status, resp.body.decode())
        return [MemberInfo(m) for m in resp.json().get("members", [])]

    def add(self, peer_urls: Sequence[str]) -> MemberInfo:
        body = json.dumps({"peerURLs": list(peer_urls)}).encode()
        resp = self.client.do("POST", "/v2/members", body, _JSON_HDR)
        if resp.status != 201:
            d = resp.json() or {}
            raise MembersError(resp.status, d.get("message",
                                                  resp.body.decode()))
        return MemberInfo(resp.json())

    def remove(self, member_id: str) -> None:
        resp = self.client.do("DELETE", f"/v2/members/{member_id}")
        if resp.status not in (204, 200):
            raise MembersError(resp.status, resp.body.decode())

    def update(self, member_id: str, peer_urls: Sequence[str]) -> None:
        body = json.dumps({"peerURLs": list(peer_urls)}).encode()
        resp = self.client.do("PUT", f"/v2/members/{member_id}", body,
                              _JSON_HDR)
        if resp.status not in (204, 200):
            raise MembersError(resp.status, resp.body.decode())

    def leader(self) -> Optional[MemberInfo]:
        """The member currently serving /v2/stats/leader (reference
        members.go Leader)."""
        for m in self.list():
            for ep in m.client_urls:
                try:
                    resp = self.client._request_one(
                        ep.rstrip("/"), "GET", "/v2/stats/leader", None, {},
                        self.client.timeout)
                except Exception:
                    continue
                if resp.status == 200:
                    return m
        return None
