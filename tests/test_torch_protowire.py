"""The port's hand-rolled ``runtime.v1`` protobuf codec
(``kubegpu_tpu_torch/crishim/protowire.py``) against hand-computed golden
bytes and against the JAX package's codec: for the reference's golden
messages and for messages hypothesis draws from every verb's schema, the
two encode byte-identical output and decode it to equal objects.  Wire
rules under test: varint field keys (num << 3 | wt), LEB128 varints,
two's-complement negative ints, length-delimited strings and messages,
map entries as {key=1, value=2} submessages, repeated fields as repeated
tags, proto3 default elision and unknown-field skipping."""

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kubegpu_tpu.crishim import protowire as ref
from kubegpu_tpu_torch.crishim import protowire as port
from kubegpu_tpu_torch.crishim.protowire import (
    MESSAGES,
    decode_message,
    decode_varint,
    encode_message,
    encode_varint,
)

VARINTS = [
    (0, b"\x00"),
    (1, b"\x01"),
    (127, b"\x7f"),
    (128, b"\x80\x01"),
    (300, b"\xac\x02"),               # the protobuf docs' example
    (1 << 32, b"\x80\x80\x80\x80\x10"),
]


@pytest.mark.parametrize("n,raw", VARINTS)
def test_known_varint_encodings(n, raw):
    assert encode_varint(n) == raw == ref.encode_varint(n)
    assert decode_varint(raw, 0) == (n, len(raw))


def test_negative_int_is_twos_complement_10_bytes():
    raw = encode_varint(-1)
    assert raw == b"\xff" * 9 + b"\x01" == ref.encode_varint(-1)
    assert decode_varint(raw, 0)[0] == (1 << 64) - 1


def test_truncated_varint_raises():
    with pytest.raises(ValueError, match="truncated"):
        decode_varint(b"\x80", 0)


def test_schemas_equal_the_references():
    """Every verb pair, field number, kind and enum value is the
    reference's (the public cri-api numbering)."""
    assert port.MESSAGES == ref.MESSAGES
    assert len(MESSAGES) == 12


def _golden():
    """(method, 0 request / 1 response, object, hand-computed bytes)."""
    pull = b"\x0a\x03a:b"
    status = (b"\x0a\x02c1" + b"\x18\x02"
              + b"\x38" + b"\xf7" + b"\xff" * 8 + b"\x01")
    entry = b"\x0a\x01k\x12\x01v"
    labels = b"\x4a" + bytes([len(entry)]) + entry
    image = b"\x0a\x01i" + b"\x12\x01a\x12\x01b" + b"\x20\x05"
    fs = (b"\x08\x07" + b"\x12\x06\x0a\x04/tmp" + b"\x1a\x03\x08\xac\x02"
          + b"\x22\x02\x08\x02")
    return [
        ("Version", 0, {"version": "v1"}, b"\x0a\x02v1"),
        ("Version", 0, {}, b""),
        ("PullImage", 0, {"image": {"image": "a:b"}},
         b"\x0a" + bytes([len(pull)]) + pull),
        ("ContainerStatus", 1,
         {"status": {"id": "c1", "state": "CONTAINER_EXITED",
                     "exit_code": -9}},
         b"\x0a" + bytes([len(status)]) + status),
        ("CreateContainer", 0, {"config": {"labels": {"k": "v"}}},
         b"\x12" + bytes([len(labels)]) + labels),
        ("ImageStatus", 1,
         {"image": {"id": "i", "repo_tags": ["a", "b"], "size": 5}},
         b"\x0a" + bytes([len(image)]) + image),
        ("ImageFsInfo", 1,
         {"image_filesystems": [{"timestamp": 7,
                                 "fs_id": {"mountpoint": "/tmp"},
                                 "used_bytes": {"value": 300},
                                 "inodes_used": {"value": 2}}]},
         b"\x0a" + bytes([len(fs)]) + fs),
    ]


GOLDEN = _golden()


@pytest.mark.parametrize("method,side,obj,want", GOLDEN,
                         ids=[f"{g[0]}-{g[1]}-{i}"
                              for i, g in enumerate(GOLDEN)])
def test_golden_bytes_equal_the_references(method, side, obj, want):
    raw = encode_message(MESSAGES[method][side], obj)
    assert raw == want
    assert raw == ref.encode_message(ref.MESSAGES[method][side], obj)
    assert decode_message(MESSAGES[method][side], raw) == \
        ref.decode_message(ref.MESSAGES[method][side], raw)


def test_decoded_golden_values():
    schema = MESSAGES["ContainerStatus"][1]
    back = decode_message(schema, GOLDEN[3][3])
    assert back["status"]["state"] == "CONTAINER_EXITED"
    assert back["status"]["exit_code"] == -9
    assert decode_message(MESSAGES["CreateContainer"][0],
                          GOLDEN[4][3])["config"]["labels"] == {"k": "v"}
    back = decode_message(MESSAGES["ImageStatus"][1], GOLDEN[5][3])
    assert back["image"]["repo_tags"] == ["a", "b"]
    assert back["image"]["size"] == 5


def test_unknown_fields_skipped():
    schema = MESSAGES["Version"][1]
    known = encode_message(schema, {"runtime_name": "rt"})
    unknown = (encode_varint((99 << 3) | 0) + encode_varint(5)
               + encode_varint((98 << 3) | 2) + b"\x03abc")
    assert decode_message(schema, unknown + known)["runtime_name"] == "rt"


def test_defaults_materialized():
    back = decode_message(MESSAGES["ImageStatus"][1], b"")
    assert back["image"] is None
    assert back["info"] == {}
    for method, (req, resp) in MESSAGES.items():
        for schema in (req, resp):
            assert decode_message(schema, encode_message(schema, {})) == \
                ref.decode_message(schema, b"")


def test_info_map_carries_the_injected_env():
    """The KubeTPU extension fields (>= 1000) carry the port's env the
    same way the reference carries its own."""
    schema = MESSAGES["CreateContainer"][1]
    obj = {"container_id": "c",
           "info": {"env": {"CUDA_VISIBLE_DEVICES": "GPU-0",
                            "TPU_VISIBLE_CHIPS": "0,1"},
                    "pid": 42, "note": "plain"}}
    raw = encode_message(schema, obj)
    assert raw == ref.encode_message(schema, obj)
    back = decode_message(schema, raw)
    assert back["info"]["env"]["CUDA_VISIBLE_DEVICES"] == "GPU-0"
    assert back["info"]["pid"] == 42 and back["info"]["note"] == "plain"


def test_truncated_field_raises():
    schema = MESSAGES["PullImage"][0]
    raw = encode_message(schema, {"image": {"image": "abc"}})
    with pytest.raises(ValueError):
        decode_message(schema, raw[:-1])


# -- hypothesis: any message of any verb ----------------------------------

_TEXT = st.text(max_size=6)
_INT = st.integers(-(1 << 63), (1 << 63) - 1)
_JSON = st.one_of(st.none(), st.booleans(), st.integers(-1000, 1000), _TEXT,
                  st.dictionaries(_TEXT, _TEXT, max_size=2))


def _message(schema: dict, depth: int = 0):
    fields = {}
    for name, (_, kind, sub) in schema.items():
        if kind == "string":
            s = _TEXT
        elif kind == "bytes":
            s = st.binary(max_size=6)
        elif kind == "int":
            s = _INT
        elif kind == "bool":
            s = st.booleans()
        elif kind == "enum":
            s = st.sampled_from(sorted(sub))
        elif kind == "message":
            if depth > 2:
                continue
            s = _message(sub, depth + 1)
        elif kind == "rep_string":
            s = st.lists(_TEXT, max_size=3)
        elif kind == "rep_message":
            if depth > 2:
                continue
            s = st.lists(_message(sub, depth + 1), max_size=2)
        elif kind == "map_str":
            s = st.dictionaries(_TEXT, _TEXT, max_size=3)
        else:   # map_json
            s = st.dictionaries(_TEXT, _JSON, max_size=3)
        fields[name] = s
    return st.fixed_dictionaries({}, optional=fields)


_SCHEMAS = [(m, side) for m in sorted(MESSAGES) for side in (0, 1)]


@st.composite
def _any_message(draw):
    method, side = draw(st.sampled_from(_SCHEMAS))
    return method, side, draw(_message(MESSAGES[method][side]))


@settings(max_examples=80, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(_any_message())
def test_any_message_encodes_as_the_reference(msg):
    method, side, obj = msg
    raw = encode_message(MESSAGES[method][side], obj)
    assert raw == ref.encode_message(ref.MESSAGES[method][side], obj)
    assert decode_message(MESSAGES[method][side], raw) == \
        ref.decode_message(ref.MESSAGES[method][side], raw)
