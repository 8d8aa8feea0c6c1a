"""The legacy (v0.1-era) GuestInput schema used by the golden fixture
/root/reference/crates/guest-prover-sp1/testdata/guest_input0.cbor.

The reference's surviving testdata predates the v0.2.5 schema: requests
carried a redaction `Template{template_hash, template, offsets, fields,
unencrypted_offset}` instead of raw request bytes + origin signature, and
`filtered_responses` were inline `{begin, length, content}` maps
(SURVEY.md §2.3).  The *tape formats are unchanged* across versions, so this
fixture remains the canonical offline test vector for the whole replay and
proving pipeline.  This module round-trips it bit-exactly.

Port copy of zktls_tpu.core.legacy (same names and values).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

from . import cbor
from .types import (
    FilteredResponse,
    GuestInput,
    GuestInputResponse,
    Request,
    RequestInfo,
)

__all__ = ["LegacyTemplate", "LegacyRequest", "LegacyGuestInput"]


@dataclass
class LegacyTemplate:
    template_hash: bytes  # 32 bytes; preimage encoding lives in zkvm-programs
    template: bytes       # public request template with redaction holes
    offsets: list[int]    # insertion offsets of private fields
    fields: list[bytes]   # private field values spliced into the template
    unencrypted_offset: int

    def to_obj(self) -> Any:
        return {
            "template_hash": self.template_hash,
            "template": self.template,
            "offsets": list(self.offsets),
            "fields": [bytes(f) for f in self.fields],
            "unencrypted_offset": self.unencrypted_offset,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "LegacyTemplate":
        return cls(
            template_hash=bytes(obj["template_hash"]),
            template=bytes(obj["template"]),
            offsets=[int(x) for x in obj["offsets"]],
            fields=[bytes(f) for f in obj["fields"]],
            unencrypted_offset=int(obj["unencrypted_offset"]),
        )

    def render(self) -> bytes:
        """Splice the private fields into the template at the given offsets.

        Offsets index into the *template*: field i is inserted at template
        position offsets[i] (verified against the fixture: offsets 25/39
        carry "httpbin.org"/"Close" into
        'GET /get HTTP/1.1\\r\\nHost: \\r\\nConnection: \\r\\n\\r\\n').
        """
        out = bytearray()
        tpos = 0
        for off, fld in zip(self.offsets, self.fields):
            out += self.template[tpos:off]
            tpos = off
            out += fld
        out += self.template[tpos:]
        return bytes(out)


@dataclass
class LegacyRequest:
    url: str
    server_name: str
    template: LegacyTemplate
    encrypted_key: bytes

    def to_obj(self) -> Any:
        return {
            "url": self.url,
            "server_name": self.server_name,
            "request": {"Template": self.template.to_obj()},
            "encrypted_key": self.encrypted_key,
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "LegacyRequest":
        (tag, body), = obj["request"].items()
        if tag != "Template":
            raise ValueError(f"unknown legacy request variant {tag!r}")
        return cls(
            url=obj["url"],
            server_name=obj["server_name"],
            template=LegacyTemplate.from_obj(body),
            encrypted_key=bytes(obj["encrypted_key"]),
        )


@dataclass
class LegacyGuestInput:
    request: LegacyRequest
    time: str
    stream: bytes
    random: bytes
    response: bytes
    filtered_responses: list[FilteredResponse] = field(default_factory=list)

    def to_obj(self) -> Any:
        return {
            "request": self.request.to_obj(),
            "response": {
                "time": self.time,
                "stream": list(self.stream),
                "random": list(self.random),
                "response": list(self.response),
                "filtered_responses": [
                    {
                        "begin": f.begin,
                        "length": f.length,
                        "content": list(f.bytes),
                    }
                    for f in self.filtered_responses
                ],
            },
        }

    @classmethod
    def from_obj(cls, obj: Any) -> "LegacyGuestInput":
        resp = obj["response"]
        return cls(
            request=LegacyRequest.from_obj(obj["request"]),
            time=resp["time"],
            stream=bytes(resp["stream"]),
            random=bytes(resp["random"]),
            response=bytes(resp["response"]),
            filtered_responses=[
                FilteredResponse(
                    begin=int(f["begin"]),
                    length=int(f["length"]),
                    bytes=bytes(f["content"]),
                )
                for f in resp["filtered_responses"]
            ],
        )

    def to_cbor(self) -> bytes:
        return cbor.dumps(self.to_obj())

    @classmethod
    def from_cbor(cls, data: bytes) -> "LegacyGuestInput":
        return cls.from_obj(cbor.loads(data))

    def to_guest_input_response(self) -> GuestInputResponse:
        """View the legacy session through the current-schema response type
        (the tapes are format-identical across schema versions)."""
        return GuestInputResponse(
            time=self.time,
            stream=self.stream,
            random=self.random,
            response=self.response,
            filtered_responses_begin=[f.begin for f in self.filtered_responses],
            filtered_responses_length=[f.length for f in self.filtered_responses],
            filtered_responses=[f.bytes for f in self.filtered_responses],
        )

    def to_guest_input(self) -> GuestInput:
        """Lift the legacy fixture into the current schema: the attested
        request bytes are the rendered redaction template."""
        return GuestInput(
            request=Request(
                version=1,
                request_info=RequestInfo(
                    request=self.request.template.render(),
                    remote_addr=self.request.url,
                    server_name=self.request.server_name,
                ),
            ),
            response=self.to_guest_input_response(),
        )
