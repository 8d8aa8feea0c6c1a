"""The zkTLS data model: Request / GuestInput and friends.

Reimplements (from scratch, in Python) the types of the external crate
`zktls-program-core` v0.2.5 as used by the reference
(core/src/prelude.rs:7-18 consumes them; wire formats recovered in
SURVEY.md §2.3 and verified against the golden fixtures
/root/reference/testdata/input.json and
/root/reference/crates/guest-prover-sp1/testdata/guest_input0.cbor).

Serialization conventions (matching serde + ciborium / serde_json):
  * JSON (human readable):  byte fields as 0x-prefixed hex (alloy style),
    plain `Vec<u8>` tape fields as arrays of numbers.
  * CBOR (non-human-readable): alloy `Bytes`/`FixedBytes` as CBOR byte
    strings, plain `Vec<u8>` as arrays of uints, structs as text-keyed maps
    in field declaration order.

Port copy of zktls_tpu.core.types (same names and values).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any

from . import cbor

__all__ = [
    "ResponseTemplate",
    "OffsetTemplate",
    "PrefixTemplate",
    "RegexTemplate",
    "RequestInfo",
    "RequestTarget",
    "RequestOrigin",
    "Request",
    "FilteredResponse",
    "GuestInputResponse",
    "GuestInput",
]


def _hex(b: bytes) -> str:
    return "0x" + bytes(b).hex()


def _unhex(s: str) -> bytes:
    if isinstance(s, (bytes, bytearray)):
        return bytes(s)
    if s.startswith(("0x", "0X")):
        s = s[2:]
    return bytes.fromhex(s)


# ---------------------------------------------------------------------------
# Response templates  (reference: ResponseTemplate enum, used at
# crates/input-builder/src/handler.rs:32,47; Offset{begin,length} |
# Prefix{prefix,length}.  A Regex variant existed as dead code in
# crates/input-builder/src/regex_cache.rs — we support it as a first-class
# template type.)
# ---------------------------------------------------------------------------


@dataclass
class OffsetTemplate:
    begin: int
    length: int

    VARIANT = "Offset"

    def to_obj(self, human: bool) -> Any:
        return {"Offset": {"begin": self.begin, "length": self.length}}


@dataclass
class PrefixTemplate:
    prefix: bytes
    length: int

    VARIANT = "Prefix"

    def to_obj(self, human: bool) -> Any:
        p = _hex(self.prefix) if human else self.prefix
        return {"Prefix": {"prefix": p, "length": self.length}}


@dataclass
class RegexTemplate:
    """Regex-extraction template (reference: regex_cache.rs:20-44, dead code
    there; live here).  Matches are extracted as (begin, length) spans."""

    regex: str

    VARIANT = "Regex"

    def to_obj(self, human: bool) -> Any:
        return {"Regex": {"regex": self.regex}}


ResponseTemplate = OffsetTemplate | PrefixTemplate | RegexTemplate


def template_from_obj(obj: Any) -> ResponseTemplate:
    if not isinstance(obj, dict) or len(obj) != 1:
        raise ValueError(f"bad ResponseTemplate: {obj!r}")
    (tag, body), = obj.items()
    if tag == "Offset":
        return OffsetTemplate(begin=int(body["begin"]), length=int(body["length"]))
    if tag == "Prefix":
        return PrefixTemplate(prefix=_unhex(body["prefix"]), length=int(body["length"]))
    if tag == "Regex":
        return RegexTemplate(regex=body["regex"])
    raise ValueError(f"unknown ResponseTemplate variant {tag!r}")


# ---------------------------------------------------------------------------
# Request  (reference schema: /root/reference/testdata/input.json)
# ---------------------------------------------------------------------------


@dataclass
class RequestInfo:
    """request: raw HTTP request bytes; remote_addr "host:port";
    server_name: SNI / certificate name."""

    request: bytes
    remote_addr: str
    server_name: str

    def to_obj(self, human: bool) -> Any:
        return {
            "request": _hex(self.request) if human else self.request,
            "remote_addr": self.remote_addr,
            "server_name": self.server_name,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "RequestInfo":
        return cls(
            request=_unhex(obj["request"]),
            remote_addr=obj["remote_addr"],
            server_name=obj["server_name"],
        )


@dataclass
class RequestTarget:
    """client: 20-byte EVM address; prover_id: 32 bytes; submit_network_id."""

    client: bytes
    prover_id: bytes
    submit_network_id: int

    def to_obj(self, human: bool) -> Any:
        return {
            "client": _hex(self.client) if human else self.client,
            "prover_id": _hex(self.prover_id) if human else self.prover_id,
            "submit_network_id": self.submit_network_id,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "RequestTarget":
        return cls(
            client=_unhex(obj["client"]),
            prover_id=_unhex(obj["prover_id"]),
            submit_network_id=int(obj["submit_network_id"]),
        )


@dataclass
class RequestOrigin:
    """Internally-tagged origin: {"type": "secp256k1", signature, nonce}."""

    type: str
    signature: bytes
    nonce: int

    def to_obj(self, human: bool) -> Any:
        return {
            "type": self.type,
            "signature": _hex(self.signature) if human else self.signature,
            "nonce": self.nonce,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "RequestOrigin":
        return cls(
            type=obj["type"],
            signature=_unhex(obj["signature"]),
            nonce=int(obj["nonce"]),
        )


@dataclass
class Request:
    """Top-level prove request (v1 schema, reference testdata/input.json)."""

    version: int
    request_info: RequestInfo
    response_template: list[ResponseTemplate] = field(default_factory=list)
    target: RequestTarget | None = None
    origin: RequestOrigin | None = None

    def to_obj(self, human: bool = True) -> Any:
        obj: dict[str, Any] = {
            "version": self.version,
            "request_info": self.request_info.to_obj(human),
            "response_template": [t.to_obj(human) for t in self.response_template],
        }
        if self.target is not None:
            obj["target"] = self.target.to_obj(human)
        if self.origin is not None:
            obj["origin"] = self.origin.to_obj(human)
        return obj

    @classmethod
    def from_obj(cls, obj: Any) -> "Request":
        return cls(
            version=int(obj["version"]),
            request_info=RequestInfo.from_obj(obj["request_info"]),
            response_template=[
                template_from_obj(t) for t in obj.get("response_template", [])
            ],
            target=RequestTarget.from_obj(obj["target"]) if "target" in obj else None,
            origin=RequestOrigin.from_obj(obj["origin"]) if "origin" in obj else None,
        )

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_obj(human=True), indent=indent)

    @classmethod
    def from_json(cls, s: str | bytes) -> "Request":
        return cls.from_obj(json.loads(s))

    def to_cbor(self) -> bytes:
        return cbor.dumps(self.to_obj(human=False))


# ---------------------------------------------------------------------------
# GuestInput  (what the prover consumes; reference: GuestInputResponse built
# at crates/input-builder/src/request.rs:72-80 and handler.rs:30-65)
# ---------------------------------------------------------------------------


@dataclass
class FilteredResponse:
    """A sub-range of the plaintext response selected by a template
    (reference: crates/input-builder/src/lib.rs:7-11)."""

    begin: int
    length: int
    bytes: bytes


@dataclass
class GuestInputResponse:
    """The recorded, replayable TLS session
    (reference: request.rs:72-80):

      time    wall-clock at session start, "sec.nanos" string — pins the
              clock for certificate-validity checking in the guest
      stream  tape of every TCP byte in both directions, framed as
              u8 direction (2=client→server, 1=server→client) ‖ u32_be len
              ‖ raw bytes  (SURVEY.md §2.3, verified against the fixture)
      random  append-only log of every byte of randomness the TLS client
              drew, in draw order, unframed
      response  full decrypted plaintext HTTP response
      filtered_responses_*  template-extracted sub-ranges of `response`
    """

    time: str
    stream: bytes
    random: bytes
    response: bytes
    filtered_responses_begin: list[int] = field(default_factory=list)
    filtered_responses_length: list[int] = field(default_factory=list)
    filtered_responses: list[bytes] = field(default_factory=list)

    def to_obj(self, human: bool) -> Any:
        def tape(b: bytes) -> Any:  # plain Vec<u8> -> array of numbers
            return list(b)

        def ab(b: bytes) -> Any:  # alloy Bytes -> hex (human) / bytes (cbor)
            return _hex(b) if human else bytes(b)

        return {
            "time": self.time,
            "stream": tape(self.stream),
            "random": tape(self.random),
            "response": tape(self.response),
            "filtered_responses_begin": list(self.filtered_responses_begin),
            "filtered_responses_length": list(self.filtered_responses_length),
            "filtered_responses": [ab(b) for b in self.filtered_responses],
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "GuestInputResponse":
        def tape(v: Any) -> bytes:
            if isinstance(v, (bytes, bytearray)):
                return bytes(v)
            return bytes(v)

        return cls(
            time=obj["time"],
            stream=tape(obj["stream"]),
            random=tape(obj["random"]),
            response=tape(obj["response"]),
            filtered_responses_begin=[int(x) for x in obj["filtered_responses_begin"]],
            filtered_responses_length=[int(x) for x in obj["filtered_responses_length"]],
            filtered_responses=[_unhex(b) if isinstance(b, str) else bytes(b)
                                for b in obj["filtered_responses"]],
        )


@dataclass
class GuestInput:
    """The full prover input: the request plus the recorded session."""

    request: Request
    response: GuestInputResponse

    def to_obj(self, human: bool = False) -> Any:
        return {
            "request": self.request.to_obj(human),
            "response": self.response.to_obj(human),
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "GuestInput":
        return cls(
            request=Request.from_obj(obj["request"]),
            response=GuestInputResponse.from_obj(obj["response"]),
        )

    def to_cbor(self) -> bytes:
        return cbor.dumps(self.to_obj(human=False))

    @classmethod
    def from_cbor(cls, data: bytes) -> "GuestInput":
        return cls.from_obj(cbor.loads(data))

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_obj(human=True), indent=indent)

    @classmethod
    def from_json(cls, s: str | bytes) -> "GuestInput":
        return cls.from_obj(json.loads(s))
