"""Export on-chain verifier contracts.

Exported EVM artifacts:

  * ZkTlsVerifier.sol — decodes the version-2 journal ABI
    (guest/journal.py), recomputes the journal wrap's MiMC digest on-chain
    and delegates the proof check;
  * Groth16Verifier.sol — a Groth16 pairing verifier with the journal
    wrap circuit's verifying key embedded, checking e(−A,B)·e(α,β)·
    e(IC,γ)·e(C,δ) = 1 through the EIP-196/197 precompiles
    (0x06/0x07/0x08);
  * vk.json — the verifying key and the circuit's parameters.

`simulate_evm_verify` mirrors the contract's exact precompile call
sequence in Python (no EVM exists here), and `simulate_zktls_verify` the
deployed pair, so the emitted logic is testable offline.  Non-EVM chains
(solana/sui/aptos/ton) get vk.json and the algorithm spec
(VERIFIER_SPEC.md).

Port copy of zktls_tpu.verifier_export: the same templates, so the
exported files are the reference's byte for byte (their text names the
reference's module paths, as the reference's files do).  Without a vk
argument the bundled snark/wrap_vk.json is used when its circuit
parameters match `wrap_circuit_params()`, else `wrap_setup()` runs.
"""

from __future__ import annotations

import pathlib

__all__ = ["export_verifier"]

_EVM_CONTRACT_TMPL = r"""// SPDX-License-Identifier: Apache-2.0
pragma solidity ^0.8.20;

/// zkTLS journal verifier (journal ABI v2, generated by zktls-tpu).
///
/// Composition: this contract recomputes the wrap circuit's public input
/// — the MiMC-Miyaguchi-Preneel digest of the journal bytes (chunked into
/// 31-byte field elements, zero-padded to MAX_CHUNKS, length-terminated;
/// zktls_tpu/snark/wrap.py) — ON-CHAIN, then calls the generated
/// Groth16Verifier with it, so the deployed pair verifies end-to-end.
///
/// Journal layout — see zktls_tpu/guest/journal.py:
///   abi.encode(uint64 version, bytes32 requestHash, bytes32 responseHash,
///              string serverName, uint64 time, address client,
///              bytes32 proverId, uint64 submitNetworkId, uint64 nonce,
///              address originSigner, bytes32 rootSpkiSha256,
///              uint64[] filteredBegins, uint64[] filteredLengths,
///              bytes[] filteredContents, bytes32 streamSha256,
///              bytes gcmRecords)
interface IGroth16Verifier {
    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata b,
        uint256[2] calldata c,
        uint256[1] calldata input
    ) external view returns (bool);
}

contract ZkTlsVerifier {
    uint256 constant RR =
        21888242871839275222246405745257275088548364400416034343698204186575808495617;
    uint256 constant CHUNK_BYTES = %CHUNK_BYTES%;
    uint256 constant MAX_CHUNKS = %MAX_CHUNKS%;

    struct Journal {
        uint64 version;
        bytes32 requestHash;
        bytes32 responseHash;
        string serverName;
        uint64 time;
        address client;
        bytes32 proverId;
        uint64 submitNetworkId;
        uint64 nonce;
        address originSigner;
        bytes32 rootSpkiSha256;
        uint64[] filteredBegins;
        uint64[] filteredLengths;
        bytes[] filteredContents;
        bytes32 streamSha256;
        bytes gcmRecords;
    }

    IGroth16Verifier public immutable proofVerifier;

    constructor(address _proofVerifier) {
        proofVerifier = IGroth16Verifier(_proofVerifier);
    }

    function mimcRoundConstants() internal pure
        returns (uint256[%N_ROUNDS%] memory rc)
    {
%RC_LINES%
    }

    /// MiMC x^5 permutation, Miyaguchi-Preneel mode (wrap.py mimc_hash).
    function mimcHash(uint256[] memory chunks) public pure
        returns (uint256 h)
    {
        uint256[%N_ROUNDS%] memory rc = mimcRoundConstants();
        for (uint256 i = 0; i < chunks.length; i++) {
            uint256 m = chunks[i] % RR;
            uint256 x = m;
            for (uint256 rIdx = 0; rIdx < %N_ROUNDS%; rIdx++) {
                uint256 t = addmod(addmod(x, h, RR), rc[rIdx], RR);
                uint256 t2 = mulmod(t, t, RR);
                uint256 t4 = mulmod(t2, t2, RR);
                x = mulmod(t4, t, RR);
            }
            h = addmod(addmod(x, h, RR), m, RR);
        }
    }

    /// 31-byte big-endian chunks, zero-padded, length-terminated.
    function journalChunks(bytes calldata journal) public pure
        returns (uint256[] memory chunks)
    {
        uint256 n = (journal.length + CHUNK_BYTES - 1) / CHUNK_BYTES;
        require(n <= MAX_CHUNKS - 1, "journal too long");
        chunks = new uint256[](MAX_CHUNKS);
        for (uint256 i = 0; i < n; i++) {
            uint256 start = i * CHUNK_BYTES;
            uint256 end = start + CHUNK_BYTES;
            if (end > journal.length) end = journal.length;
            uint256 v = 0;
            for (uint256 j = start; j < end; j++) {
                v = (v << 8) | uint8(journal[j]);
            }
            chunks[i] = v;
        }
        chunks[MAX_CHUNKS - 1] = journal.length;
    }

    function decodeJournal(bytes calldata journal)
        public pure returns (Journal memory j)
    {
        (
            j.version, j.requestHash, j.responseHash, j.serverName, j.time,
            j.client, j.proverId, j.submitNetworkId, j.nonce,
            j.originSigner, j.rootSpkiSha256, j.filteredBegins,
            j.filteredLengths, j.filteredContents, j.streamSha256,
            j.gcmRecords
        ) = abi.decode(
            journal,
            (uint64, bytes32, bytes32, string, uint64, address, bytes32,
             uint64, uint64, address, bytes32, uint64[], uint64[], bytes[],
             bytes32, bytes)
        );
        require(j.version == 2, "unsupported journal version");
    }

    /// proof = abi.encode(uint256[2] a, uint256[2][2] b, uint256[2] c)
    /// (the 256-byte EIP-197 wire layout emitted by the prover).
    function verifyAndDecode(bytes calldata journal, bytes calldata proof)
        external view returns (Journal memory j)
    {
        j = decodeJournal(journal);
        (uint256[2] memory a, uint256[2][2] memory b, uint256[2] memory c)
            = abi.decode(proof, (uint256[2], uint256[2][2], uint256[2]));
        uint256[1] memory input = [mimcHash(journalChunks(journal))];
        require(
            proofVerifier.verifyProof(a, b, c, input),
            "invalid proof"
        );
    }
}
"""


_GROTH16_CONTRACT_TMPL = r"""// SPDX-License-Identifier: Apache-2.0
pragma solidity ^0.8.20;

/// Groth16 verifier over BN254 (generated by zktls-tpu; vk embedded).
/// Checks e(-A, B) * e(alpha, beta) * e(IC(pub), gamma) * e(C, delta) == 1
/// via the EIP-196/197 precompiles.
contract Groth16Verifier {
    uint256 constant Q =
        21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant RR =
        21888242871839275222246405745257275088548364400416034343698204186575808495617;

%VK_CONSTANTS%

    function negate(uint256[2] memory p) internal pure
        returns (uint256[2] memory)
    {
        if (p[0] == 0 && p[1] == 0) return p;
        return [p[0], Q - (p[1] % Q)];
    }

    function ecAdd(uint256[2] memory a, uint256[2] memory b) internal view
        returns (uint256[2] memory r)
    {
        uint256[4] memory input = [a[0], a[1], b[0], b[1]];
        bool ok;
        assembly { ok := staticcall(gas(), 6, input, 0x80, r, 0x40) }
        require(ok, "ecAdd failed");
    }

    function ecMul(uint256[2] memory p, uint256 s) internal view
        returns (uint256[2] memory r)
    {
        uint256[3] memory input = [p[0], p[1], s];
        bool ok;
        assembly { ok := staticcall(gas(), 7, input, 0x60, r, 0x40) }
        require(ok, "ecMul failed");
    }

    function verifyProof(
        uint256[2] calldata a,
        uint256[2][2] calldata b,
        uint256[2] calldata c,
        uint256[%N_PUB%] calldata input
    ) external view returns (bool) {
        uint256[2] memory acc = [IC0_X, IC0_Y];
        uint256[2][%N_PUB%] memory ics = icPoints();
        for (uint256 i = 0; i < %N_PUB%; i++) {
            require(input[i] < RR, "input not in field");
            acc = ecAdd(acc, ecMul(ics[i], input[i]));
        }
        uint256[2] memory negA = negate([a[0], a[1]]);
        uint256[24] memory pairs;
        // e(-A, B)
        pairs[0] = negA[0]; pairs[1] = negA[1];
        pairs[2] = b[0][0]; pairs[3] = b[0][1];
        pairs[4] = b[1][0]; pairs[5] = b[1][1];
        // e(alpha, beta)
        pairs[6] = ALPHA_X; pairs[7] = ALPHA_Y;
        pairs[8] = BETA_X_IM; pairs[9] = BETA_X_RE;
        pairs[10] = BETA_Y_IM; pairs[11] = BETA_Y_RE;
        // e(IC(pub), gamma)
        pairs[12] = acc[0]; pairs[13] = acc[1];
        pairs[14] = GAMMA_X_IM; pairs[15] = GAMMA_X_RE;
        pairs[16] = GAMMA_Y_IM; pairs[17] = GAMMA_Y_RE;
        // e(C, delta)
        pairs[18] = c[0]; pairs[19] = c[1];
        pairs[20] = DELTA_X_IM; pairs[21] = DELTA_X_RE;
        pairs[22] = DELTA_Y_IM; pairs[23] = DELTA_Y_RE;
        uint256[1] memory out;
        bool ok;
        assembly {
            ok := staticcall(gas(), 8, pairs, 768, out, 0x20)
        }
        require(ok, "pairing precompile failed");
        return out[0] == 1;
    }

%IC_POINTS_FN%
}
"""


def _vk_solidity(vk):
    """Render the verifying key as Solidity constants + icPoints()."""
    a = vk["alpha1"]
    b2 = vk["beta2"]
    g2 = vk["gamma2"]
    d2 = vk["delta2"]
    ic = vk["ic"]
    n_pub = len(ic) - 1
    lines = [
        f"    uint256 constant ALPHA_X = {a[0]};",
        f"    uint256 constant ALPHA_Y = {a[1]};",
        f"    uint256 constant BETA_X_RE = {b2[0][0]};",
        f"    uint256 constant BETA_X_IM = {b2[0][1]};",
        f"    uint256 constant BETA_Y_RE = {b2[1][0]};",
        f"    uint256 constant BETA_Y_IM = {b2[1][1]};",
        f"    uint256 constant GAMMA_X_RE = {g2[0][0]};",
        f"    uint256 constant GAMMA_X_IM = {g2[0][1]};",
        f"    uint256 constant GAMMA_Y_RE = {g2[1][0]};",
        f"    uint256 constant GAMMA_Y_IM = {g2[1][1]};",
        f"    uint256 constant DELTA_X_RE = {d2[0][0]};",
        f"    uint256 constant DELTA_X_IM = {d2[0][1]};",
        f"    uint256 constant DELTA_Y_RE = {d2[1][0]};",
        f"    uint256 constant DELTA_Y_IM = {d2[1][1]};",
        f"    uint256 constant IC0_X = {ic[0][0]};",
        f"    uint256 constant IC0_Y = {ic[0][1]};",
    ]
    fn = ["    function icPoints() internal pure returns "
          f"(uint256[2][{n_pub}] memory pts) {{"]
    for i, pt in enumerate(ic[1:]):
        fn.append(f"        pts[{i}] = [uint256({pt[0]}), "
                  f"uint256({pt[1]})];")
    fn.append("    }")
    joiner = chr(10)
    return joiner.join(lines), joiner.join(fn), n_pub


def zktls_contract() -> str:
    """The journal-decoding contract with the wrap circuit's exact
    MiMC digest computation embedded (round constants + chunking)."""
    from .snark.wrap import (
        CHUNK_BYTES,
        MAX_CHUNKS,
        MIMC_ROUND_CONSTANTS,
        N_ROUNDS,
    )

    rc_lines = "\n".join(
        f"        rc[{i}] = {c};" for i, c in enumerate(MIMC_ROUND_CONSTANTS))
    return (_EVM_CONTRACT_TMPL
            .replace("%CHUNK_BYTES%", str(CHUNK_BYTES))
            .replace("%MAX_CHUNKS%", str(MAX_CHUNKS))
            .replace("%N_ROUNDS%", str(N_ROUNDS))
            .replace("%RC_LINES%", rc_lines))


def simulate_zktls_verify(vk, journal: bytes, proof_bytes: bytes) -> bool:
    """End-to-end offline mirror of the deployed pair: recompute the
    journal's MiMC digest exactly as ZkTlsVerifier does on-chain, then run
    the Groth16 pairing check exactly as Groth16Verifier does."""
    from .snark.wrap import journal_chunks, mimc_hash

    digest = mimc_hash(journal_chunks(journal))
    return simulate_evm_verify(vk, [digest], proof_bytes)


def groth16_contract(vk) -> str:
    consts, ic_fn, n_pub = _vk_solidity(vk)
    return (_GROTH16_CONTRACT_TMPL
            .replace("%VK_CONSTANTS%", consts)
            .replace("%IC_POINTS_FN%", ic_fn)
            .replace("%N_PUB%", str(n_pub)))


def simulate_evm_verify(vk, public_inputs, proof_bytes: bytes) -> bool:
    """Mirror Groth16Verifier.verifyProof's precompile call sequence in
    Python (ecMul -> ecAdd accumulation, then one ecPairing call) using the
    framework's BN254 implementation — the offline stand-in for running
    the contract on an EVM."""
    from .snark.bn254 import R as _R, g1_add, g1_mul, g1_neg, pairing_product
    from .snark.groth16 import Groth16Proof

    proof = Groth16Proof.from_bytes(proof_bytes)
    ic = vk["ic"]
    if len(public_inputs) != len(ic) - 1:
        return False
    acc = ic[0]
    for pt, v in zip(ic[1:], public_inputs):
        if not 0 <= v < _R:
            return False
        acc = g1_add(acc, g1_mul(pt, v))       # precompiles 0x07 + 0x06
    return pairing_product([                   # precompile 0x08
        (g1_neg(proof.a), proof.b),
        (vk["alpha1"], vk["beta2"]),
        (acc, vk["gamma2"]),
        (proof.c, vk["delta2"]),
    ])


def export_vk_json(vk) -> str:
    import json

    from .snark.wrap import wrap_circuit_params

    return json.dumps({
        "curve": "bn254",
        "circuit": wrap_circuit_params(),
        "alpha1": list(vk["alpha1"]),
        "beta2": [list(vk["beta2"][0]), list(vk["beta2"][1])],
        "gamma2": [list(vk["gamma2"][0]), list(vk["gamma2"][1])],
        "delta2": [list(vk["delta2"][0]), list(vk["delta2"][1])],
        "ic": [list(p) for p in vk["ic"]],
    }, indent=1)


_SPEC_MD = """# zktls-tpu Groth16 verifier spec (non-EVM chains)

Verify a 256-byte proof (A: G1, B: G2, C: G1; EIP-197 encoding, G2 limbs
imaginary-first) against vk.json over BN254:

    acc = IC[0] + sum_i input[i] * IC[i+1]        (inputs < r)
    accept iff e(-A, B) * e(alpha1, beta2) * e(acc, gamma2)
               * e(C, delta2) == 1

Solana: groth16-solana / alt_bn128 syscalls.  Sui: bn254 group ops in the
crypto natives.  Aptos: 0x1::groth16.  TON: pairing via precompiled
contracts.  All four take exactly this vk + pairing equation; wire the
journal ABI (zktls_tpu/guest/journal.py) on top.
"""


def export_verifier(target: str, out_dir: pathlib.Path,
                    vk=None) -> list[pathlib.Path]:
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if vk is None:
        # the wrap CRS is deterministic (fixed seed + fixed MAX_CHUNKS
        # circuit), so the bundled verifying key IS wrap_setup().vk();
        # loading it skips minutes of pure-Python MSM at export time.
        # The bundle embeds the circuit parameters it was generated for
        # and is only used when they match the live circuit: a stale vk
        # must never ship after a circuit change.
        bundled = pathlib.Path(__file__).parent / "snark" / "wrap_vk.json"
        vk = None
        if bundled.exists():
            import json

            from .snark.wrap import wrap_circuit_params

            raw = json.loads(bundled.read_text())
            if raw.get("circuit") == wrap_circuit_params():
                vk = {
                    "alpha1": tuple(raw["alpha1"]),
                    "beta2": (tuple(raw["beta2"][0]),
                              tuple(raw["beta2"][1])),
                    "gamma2": (tuple(raw["gamma2"][0]),
                               tuple(raw["gamma2"][1])),
                    "delta2": (tuple(raw["delta2"][0]),
                               tuple(raw["delta2"][1])),
                    "ic": [tuple(p) for p in raw["ic"]],
                }
        if vk is None:
            from .snark.wrap import wrap_setup

            vk = wrap_setup().vk()
    if target == "evm":
        f1 = out_dir / "ZkTlsVerifier.sol"
        f1.write_text(zktls_contract())
        f2 = out_dir / "Groth16Verifier.sol"
        f2.write_text(groth16_contract(vk))
        f3 = out_dir / "vk.json"
        f3.write_text(export_vk_json(vk))
        return [f1, f2, f3]
    if target in ("solana", "sui", "aptos", "ton"):
        f1 = out_dir / "vk.json"
        f1.write_text(export_vk_json(vk))
        f2 = out_dir / "VERIFIER_SPEC.md"
        f2.write_text(_SPEC_MD)
        return [f1, f2]
    raise ValueError(f"unknown target chain {target!r}")
