"""The v2 API numeric error space.

Behavioral equivalent of reference error/error.go:28-150: stable numeric
codes (100s command errors, 200s post-form errors, 300s raft, 400s etcd),
their default messages, and the HTTP status each maps to. The JSON body shape
{errorCode, message, cause, index} is part of the public API surface.
"""
from __future__ import annotations

import json

# Command-related errors.
ECODE_KEY_NOT_FOUND = 100
ECODE_TEST_FAILED = 101
ECODE_NOT_FILE = 102
ECODE_NOT_DIR = 104
ECODE_NODE_EXIST = 105
ECODE_ROOT_RONLY = 107
ECODE_DIR_NOT_EMPTY = 108
ECODE_UNAUTHORIZED = 110

# Post-form errors.
ECODE_PREV_VALUE_REQUIRED = 201
ECODE_TTL_NAN = 202
ECODE_INDEX_NAN = 203
ECODE_INVALID_FIELD = 209
ECODE_INVALID_FORM = 210
ECODE_REFRESH_VALUE = 212
ECODE_REFRESH_TTL_REQUIRED = 213

# Raft-related errors.
ECODE_RAFT_INTERNAL = 300
ECODE_LEADER_ELECT = 301

# Etcd-related errors.
ECODE_WATCHER_CLEARED = 400
ECODE_EVENT_INDEX_CLEARED = 401

_MESSAGES = {
    ECODE_KEY_NOT_FOUND: "Key not found",
    ECODE_TEST_FAILED: "Compare failed",
    ECODE_NOT_FILE: "Not a file",
    ECODE_NOT_DIR: "Not a directory",
    ECODE_NODE_EXIST: "Key already exists",
    ECODE_ROOT_RONLY: "Root is read only",
    ECODE_DIR_NOT_EMPTY: "Directory not empty",
    ECODE_UNAUTHORIZED: "The request requires user authentication",
    ECODE_PREV_VALUE_REQUIRED: "PrevValue is Required in POST form",
    ECODE_TTL_NAN: "The given TTL in POST form is not a number",
    ECODE_INDEX_NAN: "The given index in POST form is not a number",
    ECODE_INVALID_FIELD: "Invalid field",
    ECODE_INVALID_FORM: "Invalid POST form",
    ECODE_REFRESH_VALUE: "Value provided on refresh",
    ECODE_REFRESH_TTL_REQUIRED: "A TTL must be provided on refresh",
    ECODE_RAFT_INTERNAL: "Raft Internal Error",
    ECODE_LEADER_ELECT: "During Leader Election",
    ECODE_WATCHER_CLEARED: "watcher is cleared due to etcd recovery",
    ECODE_EVENT_INDEX_CLEARED: "The event in requested index is outdated and cleared",
}

# HTTP status mapping (reference error.go:116-130): defaults to 400; these
# are the exceptions.
_STATUS = {
    ECODE_KEY_NOT_FOUND: 404,
    ECODE_TEST_FAILED: 412,
    ECODE_NODE_EXIST: 412,
    ECODE_NOT_FILE: 403,
    ECODE_DIR_NOT_EMPTY: 403,
    ECODE_UNAUTHORIZED: 401,
    ECODE_RAFT_INTERNAL: 500,
    ECODE_LEADER_ELECT: 500,
}


class EtcdError(Exception):
    """An API-visible error carrying a stable numeric code."""

    def __init__(self, code: int, cause: str = "", index: int = 0) -> None:
        self.code = code
        self.message = _MESSAGES.get(code, "unknown error")
        self.cause = cause
        self.index = index
        super().__init__(f"{self.code}: {self.message} ({cause}) [{index}]")

    @property
    def status_code(self) -> int:
        return _STATUS.get(self.code, 400)

    def to_dict(self) -> dict:
        return {
            "errorCode": self.code,
            "message": self.message,
            "cause": self.cause,
            "index": self.index,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())
