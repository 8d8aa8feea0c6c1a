"""The card's peaks and the least time of the prove's Poseidon2 work: the
arithmetic behind `k1_roofline`, frozen here so that the program
cannot change its own yardstick.

The states come from the chip shapes as the port's `profile_prove.
_poseidon2_work` counts them: each committed matrix (trace, perm, quotient,
every FRI layer's pair rows) costs ceil(w / 16) width-24 leaf absorbs per
row and rows - 1 width-16 compressions.  The least time is the larger of
integer-multiply issue (each Montgomery product counted as the 3
multiplies it needs; 64 32-bit integer multiplies per clock per SM) and
HBM traffic at 3.35 TB/s (NVIDIA's H100 SXM data sheet), with bytes
counted at 4 B per field element, each read once: every committed matrix
read once, every digest and tree node written once.  SM count and the
card's maximum SM clock are read from the card.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
INT_MULS_PER_CLOCK_PER_SM = 64
MULS_PER_PRODUCT = 3
LEAF_RATE = 16
DIGEST_WIDTH = 8
#: Poseidon2 over Baby Bear: internal rounds by width (8 external rounds)
INTERNAL_ROUNDS = {16: 13, 24: 21}
EXTERNAL_ROUNDS = 8


def products(width: int) -> int:
    """Montgomery products of one permutation: 8 * w * 4 in the external
    rounds' S-boxes and matrices, RP * (4 + w) in the internal ones."""
    return EXTERNAL_ROUNDS * width * 4 + INTERNAL_ROUNDS[width] * (4 + width)


def committed_matrices(chips, stark) -> list[tuple[int, int]]:
    """(rows, width) of every matrix one prove commits, for chips
    [(rows, width, perm width, preprocessed width)] under `stark` (a dict
    of the configuration's StarkConfig fields)."""
    log_blowup = stark["log_blowup"]
    mats = []
    for n_rows, width, perm_width, pre_width in chips:
        big = n_rows << log_blowup
        mats += [(big, width), (big, 4 << log_blowup)]
        if perm_width:
            mats.append((big, perm_width))
        if pre_width:
            mats.append((big, pre_width))
    size = max(c[0] for c in chips) << log_blowup
    while size > stark["fri_final_size"]:
        mats.append((size // 2, 8))
        size //= 2
    return mats


def poseidon2_work(chips, stark) -> dict:
    """States per width, multiplies and bytes of one prove's commits."""
    mats = committed_matrices(chips, stark)
    states = {24: sum(r * -(-w // LEAF_RATE) for r, w in mats),
              16: sum(r - 1 for r, _ in mats)}
    muls = sum(n * products(w) * MULS_PER_PRODUCT for w, n in states.items())
    nbytes = sum(4 * (r * w + r * DIGEST_WIDTH + (r - 1) * DIGEST_WIDTH)
                 for r, w in mats)
    return {"states": states, "multiplies": muls, "bytes": nbytes}


def least_seconds(work: dict, card: dict) -> float:
    """The least time the card could take for `work`."""
    ops_s = work["multiplies"] / (INT_MULS_PER_CLOCK_PER_SM * card["sms"]
                                  * card["clock_mhz"] * 1e6)
    return max(ops_s, work["bytes"] / HBM_BYTES_PER_S)


def read_card(torch) -> dict:
    """The card's name, SM count, maximum SM clock and power limit."""
    props = torch.cuda.get_device_properties(0)
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm,power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().split(",")
    return {"name": torch.cuda.get_device_name(0),
            "sms": props.multi_processor_count,
            "clock_mhz": float(out[0]), "power_limit_w": float(out[1])}
