"""The recursion chips' soundness cases of tests/test_recursion_soundness.py
through the port's `check_trace`: for each honest or forged VmAir and
Sponge16Air trace, the port's chip, perm trace and `check_trace` give the
same failure list as the JAX package's, and that list is empty exactly for
the honest traces.  Also the absorb-mode pinning and the sponge trace
builder's chain-discipline refusals."""

import numpy as np
import pytest

from zktls_tpu.ops.field_ref import Fp4 as JFp4
from zktls_tpu.stark.chips import sponge as jsponge
from zktls_tpu.stark.chips import vm as jvm
from zktls_tpu.stark.debug import check_trace as jcheck_trace
from zktls_tpu_torch.ops.field_ref import Fp4
from zktls_tpu_torch.stark.chips import sponge, vm
from zktls_tpu_torch.stark.debug import check_trace

from .torch_threads import torch_threads_per_worker  # noqa: F401

#: the reference test's challenges: γ, δ, δ², …
CHALLENGE_INTS = ((3, 1, 4, 1), (2, 7, 1, 8))


def _challenges(fp4):
    delta = fp4(*CHALLENGE_INTS[1])
    return [fp4(*CHALLENGE_INTS[0]), delta] + [delta ** k
                                               for k in range(2, 37)]


def _program(mod):
    return [mod.Instr(op="const", io1=1, imm=(5, 0, 0, 0), m1=1),
            mod.Instr(op="add", ia=1, ib=1, io1=2, ra=1, rb=1, m1=1),
            mod.Instr(op="pub", io1=3, imm=(0, 0, 0, 0), m1=1),
            mod.Instr(op="azero", ia=4, ra=1)]


_VALUES = {1: (5, 0, 0, 0), 2: (10, 0, 0, 0), 3: (42, 0, 0, 0),
           4: (0, 0, 0, 0)}


def _vm_failures(mod, check, fp4, trace):
    air = mod.VmAir()
    pre = mod.vm_preprocessed(_program(mod))
    ch = _challenges(fp4)
    perm = air.generate_perm_trace(trace, [], ch, preprocessed=pre)
    return check(air, trace, [int(v) for v in perm[-1, -4:]],
                 perm_trace=perm, challenges=ch, preprocessed=pre)


def _forge_vm(trace, case):
    L = vm.LAYOUT
    if case == "const_output":          # a const row's output != its imm
        trace[0, L["o1"].start] = 12345
    elif case == "silenced_assertion":  # an azero row fed a nonzero value
        trace[3, L["a"].start] = 77
    elif case == "pub_high_limbs":      # a PUB row with a high limb set
        trace[2, L["o1"].start + 2] = 9


@pytest.mark.parametrize("case", ["honest", "const_output",
                                  "silenced_assertion", "pub_high_limbs"])
def test_vm_case_fails_as_the_reference(case):
    trace, _ = vm.vm_trace(_program(vm), _VALUES)
    jtrace, _ = jvm.vm_trace(_program(jvm), _VALUES)
    np.testing.assert_array_equal(trace, jtrace)
    _forge_vm(trace, case)
    mine = _vm_failures(vm, check_trace, Fp4, trace)
    assert mine == _vm_failures(jvm, jcheck_trace, JFp4, trace.copy())
    assert (mine == []) == (case == "honest")


def _sp_rows(mod):
    return [mod.SpongeRow(1, 0, {0: 11, 1: 22}, {0: 1}, True),
            mod.SpongeRow(1, 1, {0: 33}, {1: 1}, False),
            mod.SpongeRow(2, 0, {0: 44}, {0: 1}, False)]


def _sp_failures(mod, check, fp4, trace):
    air = mod.Sponge16Air()
    ch = _challenges(fp4)
    perm = air.generate_perm_trace(trace, [], ch)
    return check(air, trace, [int(v) for v in perm[-1, -4:]],
                 perm_trace=perm, challenges=ch)


def _forge_sponge(trace, case):
    L = sponge.Sponge16Air().L
    if case == "mid_chain_fresh":       # fresh ⇒ seq == 0 broken
        trace[1, L["fresh"].start] = 1
        trace[1, L["sp"]] = 0
    elif case == "forked_chain_nc2":    # nc is boolean
        trace[0, L["nc"].start] = 2
    elif case == "duplicate_sid_seq":   # a live repeat of (1, 1)
        trace[3, L["live"].start] = 1
        trace[3, L["sid"].start] = 1
        trace[3, L["seq"].start] = 1
    elif case == "live_after_dead":
        trace[3, L["live"].start] = 0
        trace[4, L["live"].start] = 1


@pytest.mark.parametrize("case", ["honest", "mid_chain_fresh",
                                  "forked_chain_nc2", "duplicate_sid_seq",
                                  "live_after_dead"])
def test_sponge_case_fails_as_the_reference(case):
    trace, _, _ = sponge.sponge_trace(sponge.Sponge16Air(), _sp_rows(sponge))
    jtrace, _, _ = jsponge.sponge_trace(jsponge.Sponge16Air(),
                                        _sp_rows(jsponge))
    np.testing.assert_array_equal(trace, jtrace)
    _forge_sponge(trace, case)
    mine = _sp_failures(sponge, check_trace, Fp4, trace)
    assert mine == _sp_failures(jsponge, jcheck_trace, JFp4, trace.copy())
    assert (mine == []) == (case == "honest")


def test_sponge_absorb_mode_pinned_by_bus():
    """Flipping a row's absorb mode changes its HABS fingerprints, in both
    packages alike: the bus no longer balances against the VM's sends."""
    air = sponge.Sponge16Air()
    trace, _, _ = sponge.sponge_trace(air, _sp_rows(sponge))
    flipped = trace.copy()
    flipped[0, air.L["am"].start] = 1
    ch, jch = _challenges(Fp4), _challenges(JFp4)
    p1 = air.generate_perm_trace(trace, [], ch)
    p2 = air.generate_perm_trace(flipped, [], ch)
    np.testing.assert_array_equal(
        p2, jsponge.Sponge16Air().generate_perm_trace(flipped, [], jch))
    assert not np.array_equal(p1, p2)
    assert int(p1[-1, -4]) != int(p2[-1, -4])


@pytest.mark.parametrize("rows", [
    [(1, 0, False), (3, 0, False)],      # sid gap
    [(1, 0, True), (1, 2, False)],       # seq skip
], ids=["sid_gap", "seq_skip"])
def test_sponge_trace_discipline_check(rows):
    for mod in (sponge, jsponge):
        with pytest.raises(ValueError, match="chain discipline"):
            mod.sponge_trace(mod.Sponge16Air(), [
                mod.SpongeRow(sid, seq, {}, {}, nxt)
                for sid, seq, nxt in rows])
