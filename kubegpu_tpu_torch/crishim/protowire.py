"""Hand-rolled protobuf wire-format codec for the kubelet CRI messages
(copied from ``kubegpu_tpu/crishim/protowire.py``: the same message gives
the same bytes).

A stock kubelet marshals ``runtime.v1`` protobufs, so a gRPC CRI endpoint
(``grpcserver.py``) must carry them, not JSON bodies, to exchange
*messages* and not just *frames*.  No protoc is needed: the proto wire
format is small and fully specified: varints, 3-bit wire-type tags, and
length-delimited fields.  This module implements exactly that subset —
enough for the ~12 request/response pairs the shim serves — as a
schema-driven encoder/decoder, and declares those message schemas with
the public ``k8s.io/cri-api`` ``runtime/v1/api.proto`` field numbers
(SURVEY.md §2 L2, §4.3; the reference mount is empty, so numbers follow
the public cri-api layout and are pinned by golden-bytes tests).

Wire-format rules implemented (proto3):
- varint fields (int32/int64/uint64/bool/enum): wire type 0; negative
  int32/int64 encode as 10-byte two's-complement varints;
- length-delimited (string/bytes/embedded message/map entry): wire
  type 2;
- repeated strings/messages: one tagged field per element;
- ``map<string,string>``: repeated entry message {key=1, value=2};
- proto3 presence: default-valued scalars are not emitted; absent
  singular message fields decode as ``None``; absent scalars decode to
  their defaults ("" / 0 / False), repeated → [], map → {};
- unknown fields are skipped by wire type (forward compatibility — a
  newer kubelet's extra fields must not break the shim).

KubeTPU extensions ride in the reserved-for-private range (field
numbers >= 1000): kubelet ignores unknown fields, so the endpoint stays
stock-compatible while our own client can still see e.g. the injected
env on CreateContainerResponse.  Structured values inside ``info`` maps
are JSON-encoded strings — the CRI's own convention for its verbose
info map.
"""

from __future__ import annotations

import json
from typing import Any

# -- primitive wire encoding ---------------------------------------------

_WT_VARINT = 0
_WT_I64 = 1
_WT_LEN = 2
_WT_I32 = 5

_U64_MASK = (1 << 64) - 1


def encode_varint(n: int) -> bytes:
    """Unsigned LEB128; negative ints are two's-complement 64-bit
    (proto's int32/int64 encoding — always 10 bytes when negative)."""
    n &= _U64_MASK
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, new_pos); value is the raw unsigned 64-bit quantity."""
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & _U64_MASK, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint too long")


def _signed(v: int) -> int:
    """Reinterpret an unsigned 64-bit varint as proto int64."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _tag(num: int, wt: int) -> bytes:
    return encode_varint((num << 3) | wt)


def _len_field(num: int, payload: bytes) -> bytes:
    return _tag(num, _WT_LEN) + encode_varint(len(payload)) + payload


# -- schema-driven message codec ------------------------------------------
#
# A message schema is {field_name: (field_number, kind, sub)} where kind:
#   "string" / "bytes"            length-delimited scalar
#   "int" / "bool"                varint scalar
#   "enum"                        varint via sub = {name: number} map
#   "message"                     embedded message, sub = schema
#   "rep_string" / "rep_message"  repeated
#   "map_str"                     map<string,string>
#   "map_json"                    map<string,string> with JSON-encoded
#                                 values (CRI verbose-info convention)


def encode_message(schema: dict, obj: dict | None) -> bytes:
    out = bytearray()
    obj = obj or {}
    for name, (num, kind, sub) in schema.items():
        val = obj.get(name)
        if val is None:
            continue
        if kind == "string":
            if val != "":
                out += _len_field(num, str(val).encode())
        elif kind == "bytes":
            if val:
                out += _len_field(num, bytes(val))
        elif kind == "int":
            if int(val):
                out += _tag(num, _WT_VARINT) + encode_varint(int(val))
        elif kind == "bool":
            if val:
                out += _tag(num, _WT_VARINT) + encode_varint(1)
        elif kind == "enum":
            n = sub[val] if isinstance(val, str) else int(val)
            if n:
                out += _tag(num, _WT_VARINT) + encode_varint(n)
        elif kind == "message":
            out += _len_field(num, encode_message(sub, val))
        elif kind == "rep_string":
            for item in val:
                out += _len_field(num, str(item).encode())
        elif kind == "rep_message":
            for item in val:
                out += _len_field(num, encode_message(sub, item))
        elif kind in ("map_str", "map_json"):
            for k in sorted(val):   # deterministic bytes (golden tests)
                v = val[k]
                vs = json.dumps(v) if kind == "map_json" else str(v)
                entry = (_len_field(1, str(k).encode())
                         + _len_field(2, vs.encode()))
                out += _len_field(num, entry)
        else:   # pragma: no cover — schema author error
            raise ValueError(f"unknown field kind {kind!r}")
    return bytes(out)


def _skip(data: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = decode_varint(data, pos)
        return pos
    if wt == _WT_I64:
        return pos + 8
    if wt == _WT_LEN:
        n, pos = decode_varint(data, pos)
        return pos + n
    if wt == _WT_I32:
        return pos + 4
    raise ValueError(f"unsupported wire type {wt}")


def decode_message(schema: dict, data: bytes) -> dict:
    """Decode ``data`` against ``schema``; returns a dict with every
    declared field materialized (proto3 defaults when absent; ``None``
    for absent singular messages) and unknown fields skipped."""
    by_num = {num: (name, kind, sub)
              for name, (num, kind, sub) in schema.items()}
    out: dict[str, Any] = {}
    for name, (num, kind, sub) in schema.items():
        if kind in ("rep_string", "rep_message"):
            out[name] = []
        elif kind in ("map_str", "map_json"):
            out[name] = {}
        elif kind == "message":
            out[name] = None
        elif kind == "string":
            out[name] = ""
        elif kind == "bytes":
            out[name] = b""
        elif kind == "bool":
            out[name] = False
        elif kind == "enum":
            out[name] = _enum_name(sub, 0)
        else:
            out[name] = 0
    pos = 0
    while pos < len(data):
        key, pos = decode_varint(data, pos)
        num, wt = key >> 3, key & 7
        entry = by_num.get(num)
        if entry is None:
            pos = _skip(data, pos, wt)
            continue
        name, kind, sub = entry
        if kind in ("string", "bytes", "message", "rep_string",
                    "rep_message", "map_str", "map_json"):
            if wt != _WT_LEN:
                raise ValueError(
                    f"field {name} expects length-delimited, got wt={wt}")
            n, pos = decode_varint(data, pos)
            payload = data[pos:pos + n]
            if len(payload) != n:
                raise ValueError(f"truncated field {name}")
            pos += n
            if kind == "string":
                out[name] = payload.decode()
            elif kind == "bytes":
                out[name] = payload
            elif kind == "message":
                out[name] = decode_message(sub, payload)
            elif kind == "rep_string":
                out[name].append(payload.decode())
            elif kind == "rep_message":
                out[name].append(decode_message(sub, payload))
            else:
                k, v = _decode_map_entry(payload)
                if kind == "map_json":
                    try:
                        v = json.loads(v)
                    except (json.JSONDecodeError, ValueError):
                        pass   # a foreign client may send raw strings
                out[name][k] = v
        else:
            if wt != _WT_VARINT:
                raise ValueError(
                    f"field {name} expects varint, got wt={wt}")
            raw, pos = decode_varint(data, pos)
            if kind == "bool":
                out[name] = bool(raw)
            elif kind == "enum":
                out[name] = _enum_name(sub, raw)
            else:
                out[name] = _signed(raw)
    return out


def _decode_map_entry(payload: bytes) -> tuple[str, str]:
    k = v = ""
    pos = 0
    while pos < len(payload):
        key, pos = decode_varint(payload, pos)
        num, wt = key >> 3, key & 7
        if wt != _WT_LEN:
            pos = _skip(payload, pos, wt)
            continue
        n, pos = decode_varint(payload, pos)
        s = payload[pos:pos + n].decode()
        pos += n
        if num == 1:
            k = s
        elif num == 2:
            v = s
    return k, v


def _enum_name(enum: dict, raw: int):
    for name, n in enum.items():
        if n == raw:
            return name
    return raw   # unknown enum value: surface the number


# -- runtime.v1 schemas ----------------------------------------------------
# Field numbers follow the public k8s.io/cri-api runtime/v1 api.proto;
# KubeTPU extension fields sit at >= 1000 (ignored by stock kubelets).

CONTAINER_STATE = {
    "CONTAINER_CREATED": 0,
    "CONTAINER_RUNNING": 1,
    "CONTAINER_EXITED": 2,
    "CONTAINER_UNKNOWN": 3,
}

_CONTAINER_METADATA = {
    "name": (1, "string", None),
    "attempt": (2, "int", None),
}

_IMAGE_SPEC = {
    "image": (1, "string", None),
    "annotations": (2, "map_str", None),
}

_KEY_VALUE = {
    "key": (1, "string", None),
    "value": (2, "string", None),
}

_CONTAINER_CONFIG = {
    "metadata": (1, "message", _CONTAINER_METADATA),
    "image": (2, "message", _IMAGE_SPEC),
    "command": (3, "rep_string", None),
    "args": (4, "rep_string", None),
    "working_dir": (5, "string", None),
    "envs": (6, "rep_message", _KEY_VALUE),
    "labels": (9, "map_str", None),
    "annotations": (10, "map_str", None),
}

_CONTAINER_STATUS = {
    "id": (1, "string", None),
    "metadata": (2, "message", _CONTAINER_METADATA),
    "state": (3, "enum", CONTAINER_STATE),
    "created_at": (4, "int", None),
    "started_at": (5, "int", None),
    "finished_at": (6, "int", None),
    "exit_code": (7, "int", None),
    "image": (8, "message", _IMAGE_SPEC),
    "image_ref": (9, "string", None),
    "reason": (10, "string", None),
    "message": (11, "string", None),
    "labels": (12, "map_str", None),
}

_CONTAINER = {
    "id": (1, "string", None),
    "pod_sandbox_id": (2, "string", None),
    "metadata": (3, "message", _CONTAINER_METADATA),
    "image": (4, "message", _IMAGE_SPEC),
    "image_ref": (5, "string", None),
    "state": (6, "enum", CONTAINER_STATE),
    "created_at": (7, "int", None),
    "labels": (8, "map_str", None),
    "annotations": (9, "map_str", None),
}

_IMAGE = {
    "id": (1, "string", None),
    "repo_tags": (2, "rep_string", None),
    "repo_digests": (3, "rep_string", None),
    "size": (4, "int", None),
}

_IMAGE_FILTER = {
    "image": (1, "message", _IMAGE_SPEC),
}

_CONTAINER_FILTER = {
    "id": (1, "string", None),
    "state": (2, "message", {"state": (1, "enum", CONTAINER_STATE)}),
    "pod_sandbox_id": (3, "string", None),
    "label_selector": (4, "map_str", None),
}

_UINT64_VALUE = {
    "value": (1, "int", None),
}

_FILESYSTEM_IDENTIFIER = {
    "mountpoint": (1, "string", None),
}

_FILESYSTEM_USAGE = {
    "timestamp": (1, "int", None),
    "fs_id": (2, "message", _FILESYSTEM_IDENTIFIER),
    "used_bytes": (3, "message", _UINT64_VALUE),
    "inodes_used": (4, "message", _UINT64_VALUE),
}

# method → (request schema, response schema)
MESSAGES: dict[str, tuple[dict, dict]] = {
    "Version": (
        {"version": (1, "string", None)},
        {"version": (1, "string", None),
         "runtime_name": (2, "string", None),
         "runtime_version": (3, "string", None),
         "runtime_api_version": (4, "string", None),
         # extension: which node this shim serves (tests/observability)
         "node_name": (1000, "string", None)},
    ),
    "CreateContainer": (
        {"pod_sandbox_id": (1, "string", None),
         "config": (2, "message", _CONTAINER_CONFIG)},
        {"container_id": (1, "string", None),
         # extension: the injected env + pid, JSON-valued info map
         # (the CRI verbose-info convention, private field range)
         "info": (1000, "map_json", None)},
    ),
    "StartContainer": (
        {"container_id": (1, "string", None)},
        {},
    ),
    "StopContainer": (
        {"container_id": (1, "string", None),
         "timeout": (2, "int", None)},
        {},
    ),
    "RemoveContainer": (
        {"container_id": (1, "string", None)},
        {},
    ),
    "ListContainers": (
        {"filter": (1, "message", _CONTAINER_FILTER)},
        {"containers": (1, "rep_message", _CONTAINER)},
    ),
    "ContainerStatus": (
        {"container_id": (1, "string", None),
         "verbose": (2, "bool", None)},
        {"status": (1, "message", _CONTAINER_STATUS),
         "info": (2, "map_json", None)},
    ),
    "PullImage": (
        {"image": (1, "message", _IMAGE_SPEC)},
        {"image_ref": (1, "string", None)},
    ),
    "ImageStatus": (
        {"image": (1, "message", _IMAGE_SPEC),
         "verbose": (2, "bool", None)},
        {"image": (1, "message", _IMAGE),
         "info": (2, "map_json", None)},
    ),
    "ListImages": (
        {"filter": (1, "message", _IMAGE_FILTER)},
        {"images": (1, "rep_message", _IMAGE)},
    ),
    "RemoveImage": (
        {"image": (1, "message", _IMAGE_SPEC)},
        {},
    ),
    "ImageFsInfo": (
        {},
        {"image_filesystems": (1, "rep_message", _FILESYSTEM_USAGE)},
    ),
}


def request_serializer(method: str):
    schema = MESSAGES[method][0]
    return lambda obj: encode_message(schema, obj)


def request_deserializer(method: str):
    schema = MESSAGES[method][0]
    return lambda data: decode_message(schema, data or b"")


def response_serializer(method: str):
    schema = MESSAGES[method][1]
    return lambda obj: encode_message(schema, obj)


def response_deserializer(method: str):
    schema = MESSAGES[method][1]
    return lambda data: decode_message(schema, data or b"")
