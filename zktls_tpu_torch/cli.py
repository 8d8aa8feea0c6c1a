"""zktls command-line interface of the PyTorch/CUDA port.

Mirrors the reference CLI surface (bins/zktls/src/main.rs:14-21,
commands/prove.rs:14-48):

  python -m zktls_tpu_torch.cli prove -i <request.json> -t <chain>
              [-p <prover>] [--mock | --local | --network --server <url>]
              [--fixture <recorded.cbor>] [--compress | --wrap]
              [-o <out.json>]
  python -m zktls_tpu_torch.cli serve [-p stark|mock] [--host H] [--port N]
  python -m zktls_tpu_torch.cli export-verifier [-t <chain>] [-o <dir>]

Port of zktls_tpu.cli (same flags, output lines and JSON file).  Without
`--fixture`, `prove` records a live TLS call to the request's server
(host/input_builder.py); `--fixture` replays a recorded session tape
instead.  The STARK prover runs on the CUDA card; `--network` sends the
session to a prover service at `--server` (provers/service.py), which
`serve` runs.  `--compress` wraps the machine proof in the recursion layer
and verifies it through the vk fast path; `--wrap` runs compress, shrink
and the Groth16 seal (`StarkGuestProver.wrap`) and verifies the seal.
`export-verifier` writes the on-chain verifier of the journal wrap
(verifier_export.py).
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import sys

from .core.types import GuestInput, Request

log = logging.getLogger("zktls")

TARGET_CHAINS = ["evm", "solana", "sui", "aptos", "ton"]


def _load_guest_input(args) -> GuestInput:
    request = Request.from_json(pathlib.Path(args.input).read_text())
    if not args.fixture:
        from .host.input_builder import TLSInputBuilder

        log.info("recording live TLS session to %s",
                 request.request_info.remote_addr)
        return TLSInputBuilder().build_input(request)
    data = pathlib.Path(args.fixture).read_bytes()
    try:
        gi = GuestInput.from_cbor(data)
        log.info("loaded recorded session from %s", args.fixture)
        return GuestInput(request=request, response=gi.response)
    except Exception:
        pass
    try:
        from .core.legacy import LegacyGuestInput

        legacy = LegacyGuestInput.from_cbor(data)
    except Exception:
        raise ValueError(
            f"{args.fixture!r} is not a recorded session (neither "
            "current- nor legacy-schema GuestInput CBOR)"
        ) from None
    log.info("loaded legacy-schema recorded session from %s", args.fixture)
    gi = legacy.to_guest_input()
    # keep the caller's request metadata when compatible
    if gi.request.request_info.request == request.request_info.request:
        gi.request = request
    return gi


def cmd_prove(args) -> int:
    if not pathlib.Path(args.input).exists():
        print(f"error: input file {args.input!r} does not exist",
              file=sys.stderr)
        return 2
    guest_input = _load_guest_input(args)

    if args.mock:
        from .provers.mock import MockProver

        prover = MockProver()
    elif args.network:
        from .provers.service import RemoteGuestProver

        if not args.server:
            print("error: --network needs --server", file=sys.stderr)
            return 2
        prover = RemoteGuestProver(args.server)
    else:
        from .provers.stark import StarkGuestProver

        prover = StarkGuestProver()

    output, proof = prover.prove(guest_input)
    if args.wrap and proof:
        if not hasattr(prover, "wrap"):
            print("error: --wrap needs the stark prover", file=sys.stderr)
            return 2
        log.info("wrapping: compress -> shrink -> Groth16")
        timings: dict = {}
        proof = prover.wrap(output, proof, timings=timings)
        log.info("wrap timings: %s", timings)
        assert prover.verify_wrapped(output, proof)
        log.info("Groth16 seal verified (pairing check)")
    elif args.compress and proof:
        if not hasattr(prover, "compress"):
            print("error: --compress needs the stark prover",
                  file=sys.stderr)
            return 2
        log.info("compressing: proving the verifier-VM recursion layer")
        proof = prover.compress(output, proof)
        assert prover.verify_compressed(output, proof)
        log.info("compressed proof verified (vk fast path)")
    print(f"output: 0x{output.hex()}")
    print(f"proof: 0x{proof.hex()}")
    if args.output:
        out = {
            "journal": "0x" + output.hex(),
            "proof": "0x" + proof.hex(),
            "target_chain": args.target,
        }
        pathlib.Path(args.output).write_text(json.dumps(out, indent=2))
        log.info("wrote %s", args.output)
    return 0


def cmd_serve(args) -> int:
    from .provers.service import serve

    service = serve(args.prover, args.host, args.port)
    try:
        service.serve_forever()
    except KeyboardInterrupt:
        service.stop()
    return 0


def cmd_export_verifier(args) -> int:
    from .verifier_export import export_verifier

    out_dir = pathlib.Path(args.output or f"verifier-{args.target}")
    files = export_verifier(args.target, out_dir)
    for f in files:
        print(f"wrote {f}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zktls",
        description="zkTLS prover on a CUDA card (PyTorch port; "
        "capabilities of the3cloud/zktls)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("prove", help="prove a TLS session")
    pr.add_argument("-i", "--input", required=True,
                    help="request JSON file")
    pr.add_argument("-t", "--target", choices=TARGET_CHAINS, default="evm",
                    help="target chain for the proof")
    pr.add_argument("-p", "--prover", choices=["stark", "mock"],
                    default="stark", help="prover backend")
    mode = pr.add_mutually_exclusive_group()
    mode.add_argument("--mock", action="store_true",
                      help="execute the guest, emit real journal + empty proof")
    mode.add_argument("--local", action="store_true",
                      help="prove on the local CUDA card (default)")
    mode.add_argument("--network", action="store_true",
                      help="delegate proving to a remote prover service "
                      "(the reference's moongate/Bonsai mode)")
    pr.add_argument("--server",
                    default=None,
                    help="prover service URL for --network")
    pr.add_argument("--fixture", help="recorded session CBOR to replay "
                    "(otherwise a live TLS call is recorded)")
    pr.add_argument("--compress", action="store_true",
                    help="wrap the machine proof in the recursion layer")
    pr.add_argument("--wrap", action="store_true",
                    help="full chain to a 256-byte Groth16 seal: "
                    "compress -> shrink (BN254/MiMC) -> Groth16 "
                    "(the STARK verifier is the circuit)")
    pr.add_argument("-o", "--output", help="write journal+proof JSON here")
    pr.set_defaults(func=cmd_prove)

    ev = sub.add_parser("export-verifier",
                        help="export an on-chain verifier contract")
    ev.add_argument("-t", "--target", choices=TARGET_CHAINS, default="evm")
    ev.add_argument("-p", "--prover", choices=["stark"], default="stark")
    ev.add_argument("-o", "--output", help="output directory")
    ev.set_defaults(func=cmd_export_verifier)

    sv = sub.add_parser("serve",
                        help="run a prover service")
    sv.add_argument("-p", "--prover", choices=["stark", "mock"],
                    default="stark", help="prover backend to serve")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8472)
    sv.set_defaults(func=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s",
    )
    try:
        return args.func(args)
    except Exception as e:  # mirror the reference: print, don't propagate
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
