"""TLS input builder: performs a live, recorded TLS session and applies
response templates (reference: crates/input-builder/src/handler.rs:8-115 +
request.rs:13-80).

Port copy of zktls_tpu.host.input_builder.  The recording client lives in
zktls_tpu_torch.host.recorder; this module
orchestrates it and extracts filtered responses:

  * Offset templates: direct (begin, length) sub-ranges (handler.rs:73-86);
  * Prefix templates: find the prefix, take `length` bytes after it
    (handler.rs:88-115 — NOTE the reference's implementation is broken in
    the snapshot: `Finder::new(response)` searches the response for itself
    [V, SURVEY.md §2.1]; this implementation does what was intended);
  * Regex templates: regex match spans (regex_cache.rs — dead code there,
    functional here).
"""

from __future__ import annotations

import re

from ..core.types import (
    FilteredResponse,
    GuestInput,
    GuestInputResponse,
    OffsetTemplate,
    PrefixTemplate,
    RegexTemplate,
    Request,
)

__all__ = ["TLSInputBuilder", "apply_templates"]


def apply_templates(response: bytes, templates) -> list[FilteredResponse]:
    out: list[FilteredResponse] = []
    for t in templates:
        if isinstance(t, OffsetTemplate):
            begin, length = t.begin, t.length
            if begin + length > len(response):
                raise ValueError(
                    f"offset template [{begin}, {begin + length}) out of "
                    f"range for {len(response)}-byte response"
                )
            out.append(FilteredResponse(begin, length,
                                        response[begin : begin + length]))
        elif isinstance(t, PrefixTemplate):
            pos = response.find(t.prefix)
            if pos < 0:
                raise ValueError(f"prefix {t.prefix!r} not found in response")
            begin = pos + len(t.prefix)
            if begin + t.length > len(response):
                raise ValueError("prefix template range out of response")
            out.append(FilteredResponse(begin, t.length,
                                        response[begin : begin + t.length]))
        elif isinstance(t, RegexTemplate):
            m = re.search(t.regex.encode(), response)
            if m is None:
                raise ValueError(f"regex {t.regex!r} matched nothing")
            out.append(FilteredResponse(m.start(), m.end() - m.start(),
                                        response[m.start() : m.end()]))
        else:
            raise TypeError(f"unknown template {t!r}")
    return out


class TLSInputBuilder:
    """InputBuilder performing a live recorded TLS call.

    `cafile` is a test hook (loopback recording against a local TLS
    server with a custom trust root); `rng` and `suites` are passed to the
    recorder (the client's random bytes, `os.urandom` when None; the
    offered cipher suites, the recorder's list when None); `now` pins the
    recorded time (the wall clock when None)."""

    def __init__(self, cafile: str | None = None, timeout: float = 30.0,
                 rng=None, suites=None, now=None):
        self.cafile = cafile
        self.now = now
        self.timeout = timeout
        self.rng = rng
        self.suites = suites

    def build_input(self, request: Request) -> GuestInput:
        from .recorder import record_tls_call

        recorded = record_tls_call(
            remote_addr=request.request_info.remote_addr,
            server_name=request.request_info.server_name,
            request_bytes=request.request_info.request,
            cafile=self.cafile,
            timeout=self.timeout,
            rng=self.rng,
            suites=self.suites,
            now=self.now,
        )
        filtered = apply_templates(recorded.response,
                                   request.response_template)
        return GuestInput(
            request=request,
            response=GuestInputResponse(
                time=recorded.time,
                stream=recorded.stream,
                random=recorded.random,
                response=recorded.response,
                filtered_responses_begin=[f.begin for f in filtered],
                filtered_responses_length=[f.length for f in filtered],
                filtered_responses=[f.bytes for f in filtered],
            ),
        )
