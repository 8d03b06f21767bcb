"""STRELA ISA: operation sets and per-PE configuration words.

The paper (Sec. III-C / V-B / V-C) specifies:
  * integer ALU ops: add, sub, mult, shift, AND, OR, XOR
  * comparator ops: "equal to zero" and "greater than zero"
  * Join/Merge modes: Join-without-control / Join-with-control / Merge
  * datapath output mux: ALU | comparator | if-else multiplexer
  * an immediate-feedback-loop mux on one ALU operand (data reductions)
  * initial values for the FU data register and the three valid registers
  * Fork-Sender masks, a programmable delay for the unprocessed valid
  * per-PE configuration of 158 bits total, streamed as five 32-bit words
    (Sec. V-B: the deserializer forms a "152-bit configuration word" = 146
    functional + 6 PE-id; Sec. V-C adds 6 clock-gating bits -> 158). Note
    the paper's Sec. V-C text says "144 bits for reconfigurable elements",
    which is inconsistent with its own 152/158 totals; we follow the totals
    (146 + 6 + 6 = 158).

The paper publishes only field totals, not the internal split; the concrete
layout below is our reconstruction, asserted to sum to exactly 146
functional / 158 total bits in ``tests/test_isa.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Tuple

# ---------------------------------------------------------------------------
# Operation sets
# ---------------------------------------------------------------------------


class AluOp(enum.IntEnum):
    """Integer ALU operations supported by every FU (homogeneous fabric)."""

    NOP = 0        # route-through / disabled
    ADD = 1
    SUB = 2
    MUL = 3
    SHL = 4        # "shift" — left
    SHR = 5        # "shift" — arithmetic right
    AND = 6
    OR = 7
    XOR = 8


class CmpOp(enum.IntEnum):
    """Comparator operations (generate 1-bit control tokens)."""

    NONE = 0
    EQZ = 1        # (a - b) == 0  (b defaults to const 0)
    GTZ = 2        # (a - b) >  0


class JoinMergeMode(enum.IntEnum):
    """Modes of the Join/Merge module at the FU front-end (Sec. III-C)."""

    JOIN = 0         # two operand inputs, no control
    JOIN_CTRL = 1    # two operands + control (Branch or if/else mux)
    MERGE = 2        # two operands, internally generated control


class OutMux(enum.IntEnum):
    """Final datapath multiplexer: which unit drives the FU output register."""

    ALU = 0
    CMP = 1
    MUX = 2          # if/else datapath multiplexer


class OperandSel(enum.IntEnum):
    """FU data-input multiplexer sources (Fig. 3)."""

    PORT_N = 0
    PORT_E = 1
    PORT_S = 2
    PORT_W = 3
    CONST = 4
    FEEDBACK = 5     # non-immediate feedback from dout_FU


class CtrlSel(enum.IntEnum):
    """FU control-input sources — PE input ports only (Fig. 3)."""

    PORT_N = 0
    PORT_E = 1
    PORT_S = 2
    PORT_W = 3


# Cardinal order used across the whole code base.
CARDINALS: Tuple[str, ...] = ("N", "E", "S", "W")

# Fork-sender destination order for a *PE input port*:
#   FU operand a, FU operand b, FU control, and the three other PE outputs.
PE_IN_DESTS: Tuple[str, ...] = ("FU_A", "FU_B", "FU_C", "OUT_0", "OUT_1", "OUT_2")

# Fork-sender destination order for the *FU output*:
#   two non-immediate feedback loops + the four cardinal PE outputs.
FU_OUT_DESTS: Tuple[str, ...] = ("FB1", "FB2", "OUT_N", "OUT_E", "OUT_S", "OUT_W")


# ---------------------------------------------------------------------------
# Configuration word
# ---------------------------------------------------------------------------

# (field name, bit width) — functional part; must total 144 bits.
_FUNC_FIELDS: List[Tuple[str, int]] = [
    ("alu_op", 4),             # AluOp
    ("alu_fb_imm", 1),         # immediate feedback mux on ALU operand b
    ("cmp_op", 2),             # CmpOp
    ("jm_mode", 2),            # JoinMergeMode
    ("out_mux", 2),            # OutMux
    ("data_reg_init", 32),     # initial value of the FU data register
    ("valid_reg_init", 3),     # initial values of the three valid registers
    ("fu_fork_mask", 6),       # FU-output Fork-Sender mask (FU_OUT_DESTS)
    ("valid_delay", 6),        # delay of the unprocessed valid (loop exits)
    ("in_a_sel", 3),           # OperandSel
    ("in_b_sel", 3),           # OperandSel
    ("ctrl_sel", 2),           # CtrlSel
    ("const_val", 32),         # per-PE constant operand
    ("in_fork_mask_n", 6),     # PE input-port Fork-Sender masks (PE_IN_DESTS)
    ("in_fork_mask_e", 6),
    ("in_fork_mask_s", 6),
    ("in_fork_mask_w", 6),
    ("out_sel_n", 3),          # PE output-port muxes: 0..3 -> input N/E/S/W,
    ("out_sel_e", 3),          #   4 -> FU out, 5 -> FU out delayed, 6 -> off
    ("out_sel_s", 3),
    ("out_sel_w", 3),
    ("branch_swap", 1),        # swap Branch taken/not-taken valid outputs
    ("reserved", 11),          # reconstruction slack (paper gives totals only)
]

FUNC_BITS = sum(w for _, w in _FUNC_FIELDS)
ID_BITS = 6
GATE_BITS = 6
TOTAL_BITS = FUNC_BITS + ID_BITS + GATE_BITS          # 158 per the paper
WORDS_PER_PE = 5                                      # five 32-bit words


class OutSel(enum.IntEnum):
    """PE output-port mux sources."""

    IN_N = 0
    IN_E = 1
    IN_S = 2
    IN_W = 3
    FU = 4
    FU_DELAYED = 5
    OFF = 6


@dataclasses.dataclass
class PEConfig:
    """Decoded configuration of one PE. Field names mirror ``_FUNC_FIELDS``."""

    alu_op: AluOp = AluOp.NOP
    alu_fb_imm: int = 0
    cmp_op: CmpOp = CmpOp.NONE
    jm_mode: JoinMergeMode = JoinMergeMode.JOIN
    out_mux: OutMux = OutMux.ALU
    data_reg_init: int = 0
    valid_reg_init: int = 0
    fu_fork_mask: int = 0
    valid_delay: int = 0
    in_a_sel: OperandSel = OperandSel.PORT_N
    in_b_sel: OperandSel = OperandSel.PORT_N
    ctrl_sel: CtrlSel = CtrlSel.PORT_N
    const_val: int = 0
    in_fork_mask_n: int = 0
    in_fork_mask_e: int = 0
    in_fork_mask_s: int = 0
    in_fork_mask_w: int = 0
    out_sel_n: OutSel = OutSel.OFF
    out_sel_e: OutSel = OutSel.OFF
    out_sel_s: OutSel = OutSel.OFF
    out_sel_w: OutSel = OutSel.OFF
    branch_swap: int = 0
    reserved: int = 0
    # non-functional fields
    pe_id: int = 0
    gate_mask: int = 0    # per-Elastic-Buffer clock gating (6 EB groups)

    # -- encoding ----------------------------------------------------------
    def encode(self) -> int:
        """Pack into a 158-bit integer (functional | id | gating)."""
        value = 0
        shift = 0
        for name, width in _FUNC_FIELDS:
            field = int(getattr(self, name)) & ((1 << width) - 1)
            value |= field << shift
            shift += width
        value |= (self.pe_id & ((1 << ID_BITS) - 1)) << shift
        shift += ID_BITS
        value |= (self.gate_mask & ((1 << GATE_BITS) - 1)) << shift
        return value

    def to_words(self) -> List[int]:
        """Serialize as five 32-bit configuration words (bus format)."""
        packed = self.encode()
        return [(packed >> (32 * i)) & 0xFFFFFFFF for i in range(WORDS_PER_PE)]

    @classmethod
    def decode(cls, value: int) -> "PEConfig":
        kwargs = {}
        shift = 0
        for name, width in _FUNC_FIELDS:
            raw = (value >> shift) & ((1 << width) - 1)
            shift += width
            kwargs[name] = raw
        pe_id = (value >> shift) & ((1 << ID_BITS) - 1)
        shift += ID_BITS
        gate = (value >> shift) & ((1 << GATE_BITS) - 1)
        cfg = cls(**kwargs)  # type: ignore[arg-type]
        cfg.alu_op = AluOp(cfg.alu_op)
        cfg.cmp_op = CmpOp(cfg.cmp_op)
        cfg.jm_mode = JoinMergeMode(cfg.jm_mode)
        cfg.out_mux = OutMux(cfg.out_mux)
        cfg.in_a_sel = OperandSel(cfg.in_a_sel)
        cfg.in_b_sel = OperandSel(cfg.in_b_sel)
        cfg.ctrl_sel = CtrlSel(cfg.ctrl_sel)
        cfg.out_sel_n = OutSel(cfg.out_sel_n)
        cfg.out_sel_e = OutSel(cfg.out_sel_e)
        cfg.out_sel_s = OutSel(cfg.out_sel_s)
        cfg.out_sel_w = OutSel(cfg.out_sel_w)
        cfg.pe_id = pe_id
        cfg.gate_mask = gate
        return cfg

    @classmethod
    def from_words(cls, words: List[int]) -> "PEConfig":
        assert len(words) == WORDS_PER_PE
        value = 0
        for i, w in enumerate(words):
            value |= (w & 0xFFFFFFFF) << (32 * i)
        return cls.decode(value)


def config_stream(configs: List[PEConfig]) -> List[int]:
    """Flatten PE configs into the 32-bit word stream fetched by IMN-0.

    Mirrors Sec. V-B: each PE's five words are tagged by the 6-bit PE id that
    is part of the encoded word itself, enabling variable-size kernel
    configurations (only active PEs are streamed).
    """
    words: List[int] = []
    for cfg in configs:
        words.extend(cfg.to_words())
    return words


def config_cycles(n_pes: int, n_imns_for_config: int = 1) -> int:
    """Clock cycles to fetch a kernel configuration.

    One IMN fetches ``WORDS_PER_PE`` words per PE, one word/cycle (32-bit bus
    beat), plus a small fixed deserializer/launch overhead. Calibrated against
    Table I: fft uses 16 PEs -> 84 cycles, relu/dither use 14 PEs -> 74.
    With overhead=4: 16*5+4 = 84, 14*5+4 = 74.  (find2min: 16 PEs -> 84.)
    """
    return n_pes * WORDS_PER_PE // n_imns_for_config + 4
