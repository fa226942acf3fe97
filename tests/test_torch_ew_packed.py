"""The int16 arithmetic of the ``ew`` kernel (``csrc/vpu_select.cu``
``EwI16x2``), two elements in a 32-bit word, emulated in numpy on uint32
words against ``ew_plain`` on every int16 value; and the SASS reader that
counts the kernel's instructions a round on the card.

The kernel's constants are read from its source, so a wrong mask or byte
permute there fails here: a round is ``twice = (w << 1) & mask``, ``square``
the byte permute ``{(w * w).lo, ((w >> 16) * (w >> 16)).lo}`` and the
signed 16x2 max of the two.
"""

import os
import re

import numpy as np
import pytest
import torch

from pointcloud_orientation_tpu_torch.benchmarks import profile_vpu_select as PV

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "pointcloud_orientation_tpu_torch", "csrc", "vpu_select.cu")


def _constant(name: str) -> int:
    with open(SOURCE) as f:
        m = re.search(rf"constexpr unsigned {name} = (0x[0-9a-fA-F]+)u;", f.read())
    assert m, f"{name} not found in {SOURCE}"
    return int(m.group(1), 16)


MASK = _constant("kEwI16DoubleMask")
PERM = _constant("kEwI16JoinPerm")


def _byte_perm(a: np.ndarray, b: np.ndarray, selector: int) -> np.ndarray:
    """``__byte_perm(a, b, selector)``: byte i of the result is byte
    ``(selector >> 4i) & 7`` of the eight bytes {a.b0..a.b3, b.b0..b.b3}."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a)
    for i in range(4):
        out |= pool[(selector >> (4 * i)) & 7] << (8 * i)
    return out


def _max_s16x2(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """PTX ``max.s16x2``: the signed max of each 16-bit half."""
    halves = []
    for shift in (0, 16):
        x = ((a >> shift) & 0xFFFF).astype(np.uint16).view(np.int16)
        y = ((b >> shift) & 0xFFFF).astype(np.uint16).view(np.int16)
        halves.append(np.maximum(x, y).view(np.uint16).astype(np.uint32) << shift)
    return halves[0] | halves[1]


def _round_i16x2(w: np.ndarray, mask: int, perm: int) -> np.ndarray:
    """One round of ``EwI16x2::round`` on uint32 words (products wrap
    modulo 2^32, as the card's 32-bit multiply)."""
    twice = (w << np.uint32(1)) & np.uint32(mask)
    hi = w >> np.uint32(16)
    return _max_s16x2(twice, _byte_perm(w * w, hi * hi, perm))


def _every_pair():
    """Words holding every int16 value in each half, with varied partners:
    the low half v, the high half the values in a fixed shuffled order."""
    lo = np.arange(-2 ** 15, 2 ** 15, dtype=np.int32).astype(np.int16)
    hi = lo[np.random.default_rng(0).permutation(lo.size)]
    words = lo.view(np.uint16).astype(np.uint32) | (hi.view(np.uint16).astype(np.uint32) << 16)
    return words, torch.from_numpy(lo.copy()), torch.from_numpy(hi.copy())


def _first_difference(mask: int, perm: int, max_reps: int = 33):
    """The first (reps, half) at which the emulated packed rounds differ
    from ``ew_plain`` on every int16 value, reps 0 to ``max_reps``; None
    when they agree everywhere."""
    words, lo, hi = _every_pair()
    with np.errstate(over="ignore"):
        for reps in range(max_reps + 1):
            got_lo = (words & 0xFFFF).astype(np.uint16).view(np.int16)
            got_hi = (words >> 16).astype(np.uint16).view(np.int16)
            if not np.array_equal(got_lo, lo.numpy()):
                return reps, "low"
            if not np.array_equal(got_hi, hi.numpy()):
                return reps, "high"
            words = _round_i16x2(words, mask, perm)
            lo, hi = PV.ew_plain(lo, 1), PV.ew_plain(hi, 1)
    return None


def test_packed_int16_rounds_equal_the_plain_version_on_every_value():
    """The kernel's mask and byte permute, read from its source: both
    halves of every word equal ``ew_plain`` (one round at a time, int16
    wrapping) after 0 to 33 rounds, on all 65,536 values in each half."""
    assert _first_difference(MASK, PERM) is None
    # wrapping: 2 * -32768 and 32767 ** 2 and 182 ** 2 modulo 2^16 (0, 1, -32412)
    assert PV.ew_plain(torch.tensor([-32768, 32767, 181, -182], dtype=torch.int16), 1).tolist() \
        == [0, 1, 32761, -364]


@pytest.mark.parametrize("mask,perm,half", [
    (0xFFFFFFFF, PERM, "high"),  # the low half's doubling carries into the high half
    (0xFFFEFFFD, PERM, "low"),  # bit 1 of the low half's doubled value cleared
    (MASK, 0x1054, "low"),  # the halves of the square swapped
    (MASK, 0x5432, "low"),  # the high half of w * w taken for lo * lo
    (MASK, 0x7610, "high"),  # the high half of (w >> 16)^2 (zero) for hi * hi
], ids=["no-carry-mask", "mask-drops-bit-1", "halves-swapped", "lo-from-high-half",
        "hi-from-high-half"])
def test_packed_int16_emulation_fails_on_a_wrong_mask_or_permute(mask, perm, half):
    """The emulation is sensitive to each constant: each mutation differs
    from the plain version within the first round, in the half it
    breaks."""
    assert _first_difference(mask, perm, max_reps=2) == (1, half)


_SASS = """
        Function : _ZN12_GLOBAL__N_19ew_kernelINS_5EwF32ELi32ELi4EEEvPK5uint4PS3_lii
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/              @!P0 BRA `(.L_x_0) ;
.L_x_1:
        /*0030*/                   LDG.E.128.CONSTANT R8, desc[UR4][R2.64] ;
        /*0040*/                   FADD R4, R4, R4 ;
        /*0050*/                   FMUL R5, R4, R4 ;
        /*0060*/                   FMNMX.NAN R4, R4, R5, !PT ;
        /*0070*/                   STG.E.128 desc[UR4][R6.64], R4 ;
        /*0080*/               @P0 BRA `(.L_x_1) ;
.L_x_0:
        /*0090*/                   EXIT ;
        /*00a0*/                   BRA `(.L_x_2) ;
.L_x_2:
        /*00b0*/                   NOP ;
"""


def test_sass_loop_counts_the_instructions_of_the_longest_loop():
    """The reader takes the span of the backward branch (the grid-stride
    loop), predicates and modifiers dropped; the forward branches and the
    self-branch after EXIT are not loops that span anything."""
    count, ops = PV.sass_loop(_SASS)
    assert count == 6
    assert ops == {"LDG": 1, "FADD": 1, "FMUL": 1, "FMNMX": 1, "STG": 1, "BRA": 1}
    assert PV.sass_loop("no code here") == (0, {})


def test_issue_floor_counts_128_instructions_a_clock_an_sm():
    # 3 instructions an element-round, (64, 128, 1024) elements, 32 rounds,
    # 132 SMs at 1,980 MHz: 0.0243 ms
    floor = PV.issue_floor_ms(3.0, 64 * 128 * 1024, 32, 132, 1980.0)
    assert floor == pytest.approx(3 * 64 * 128 * 1024 * 32 / (128 * 132 * 1.98e9) * 1e3)
    assert 0.024 < floor < 0.025
