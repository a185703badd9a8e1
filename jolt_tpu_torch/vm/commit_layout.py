"""Declarative commitment layout shared by the Jolt prover and verifier.

The reference hardens commitment/opening ordering with pointer-identity
tests over its `JoltStuff` struct (jolt-core/src/jolt/vm/mod.rs JoltStuff +
memory_checking.rs:161-196 initialize_verifier_openings).  Round 1 routed
verifier commitments by hand-maintained magic offsets in vm/jolt.py — and
indeed carried a latent off-by-C bug in the timestamp slice that the Mock
PCS could never catch.  This module is the single source of truth: named
sections with computed offsets, used by BOTH the prover (assembling the
batch-commit list, with per-section length assertions) and the verifier
(slicing commitments back out by name).
"""
from __future__ import annotations

from dataclasses import dataclass


def _sections_rw(C: int, m: int, ni: int, n_flags: int, num_aux: int
                 ) -> list[tuple[str, int]]:
    """(name, count) pairs in exact batch-commit order.

    Order mirrors the reference's JoltPolynomials flattening: bytecode ‖
    read_write_memory ‖ instruction_lookups ‖ timestamp_range_check ‖
    r1cs (vm/mod.rs:393 commit order).
    """
    return [
        ("bc_a_read_write", 1),
        ("bc_v_read_write", 6),
        ("bc_t_read", 1),
        ("ram_a", 1),
        ("ram_v_read", 7),
        ("ram_v_write_rd", 1),
        ("ram_v_write_ram", 4),
        ("ram_t_read", 7),
        ("ram_t_write_ram", 4),
        ("il_dim", C),
        ("il_read_cts", m),
        ("il_E", m),
        ("il_flags", ni),
        ("il_outputs", 1),
        ("ts_read_cts_read_timestamp", 7),
        ("ts_read_cts_global_minus_read", 7),
        ("ts_final_cts_read_timestamp", 7),
        ("ts_final_cts_global_minus_read", 7),
        ("r1cs_chunks_x", C),
        ("r1cs_chunks_y", C),
        ("r1cs_circuit_flags", n_flags),
        ("r1cs_aux", num_aux),
    ]


def _sections_if(m: int) -> list[tuple[str, int]]:
    return [
        ("bc_t_final", 1),
        ("ram_v_final", 1),
        ("ram_t_final", 1),
        ("il_final_cts", m),
    ]


@dataclass(frozen=True)
class CommitLayout:
    """Named slices into the read_write / init_final commitment lists."""
    rw_slices: dict
    if_slices: dict
    rw_total: int
    if_total: int

    def rw(self, items: list, name: str) -> list:
        """Slice the read_write list by section name."""
        return items[self.rw_slices[name]]

    def rw1(self, items: list, name: str):
        """Single-entry read_write section -> the entry itself."""
        s = self.rw_slices[name]
        assert s.stop - s.start == 1, f"{name} is not a singleton section"
        return items[s.start]

    def if_(self, items: list, name: str) -> list:
        """Slice the init_final list by section name."""
        return items[self.if_slices[name]]

    def if1(self, items: list, name: str):
        s = self.if_slices[name]
        assert s.stop - s.start == 1, f"{name} is not a singleton section"
        return items[s.start]

    def check_rw(self, items: list) -> None:
        assert len(items) == self.rw_total, \
            (f"read_write commitment list has {len(items)} entries, layout "
             f"expects {self.rw_total} — a section is out of sync")

    def check_if(self, items: list) -> None:
        assert len(items) == self.if_total, \
            (f"init_final commitment list has {len(items)} entries, layout "
             f"expects {self.if_total} — a section is out of sync")


def build_commit_layout(C: int, num_memories: int, num_instructions: int,
                        num_circuit_flags: int, num_aux: int) -> CommitLayout:
    def build(sections):
        slices, off = {}, 0
        for name, n in sections:
            slices[name] = slice(off, off + n)
            off += n
        return slices, off

    rw_slices, rw_total = build(_sections_rw(
        C, num_memories, num_instructions, num_circuit_flags, num_aux))
    if_slices, if_total = build(_sections_if(num_memories))
    return CommitLayout(rw_slices, if_slices, rw_total, if_total)
