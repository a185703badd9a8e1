"""A one-call proving facade: the analogue of the reference SDK's
`#[jolt::provable]` macro output (jolt_tpu/sdk.py).

The reference macro (jolt-sdk/macros/src/lib.rs:89-128) turns each guest
function into `build_f() -> (prove_closure, verify_closure)`; the two
closures share one preprocessing, and the prove closure returns
`(output, proof)`.  Here the guest is an assembled RV32IM program, a list
of `ELFInstruction` or the raw bytes of an ELF file, and the same shape is
kept: `build_provable` returns `(prove, verify)` closures over a
preprocessing built at the first `prove` and reused while the next trace
still fits its SRS.

    prove, verify = build_provable(elf_bytes)       # on the CUDA card
    outputs, artifacts = prove(b"\\x05" * 32)
    data = proof_to_bytes(artifacts)                 # canonical bytes
    assert verify(proof_from_bytes(data))

`ark_proof_bytes` gives the arkworks `JoltHyperKZGProof` bytes that the
reference's Rust verifier reads.
"""
from __future__ import annotations

from dataclasses import dataclass

from ._device import resolve_device
from .commitment.hyperkzg import HyperKZG
from .commitment.mock import MockCommitmentScheme
from .tracer.elf import decode_elf
from .utils.ark_proof import serialize_jolt_hyperkzg_proof
from .utils.serialization import (deserialize_jolt_proof_with_commitments,
                                  serialize_jolt_proof_with_commitments)
from .vm.host import trace_program
from .vm.rv32i_vm import rv32i_vm


@dataclass
class ProveArtifacts:
    """Everything `verify` needs: the reference's prove output (lib.rs
    :115-127, the output and the proof)."""
    proof: object
    commitments: object
    outputs: bytes
    trace_length: int


def build_provable(program, *, pcs: str = "hyperkzg", spec=None,
                   min_srs_log2: int = 0, device=None):
    """`(prove, verify)` closures sharing one cached preprocessing on
    `device` (default: the CUDA card).

    `program`: a list of ELFInstruction (the mini-assembler's output) or
    the bytes of an ELF file (decoded by tracer/elf.py, the host/
    mod.rs:168-175 path).  The tracer takes no memory image and starts at
    the lowest instruction address, so `prove` raises on an ELF file with
    data sections and `build_provable` on one whose entry lies elsewhere.
    `pcs`: "hyperkzg" (the reference's default, rv32i_vm.rs:228) or "mock".
    """
    if pcs not in ("hyperkzg", "mock"):
        raise ValueError(f"unknown pcs {pcs!r}")
    dev = resolve_device(device)
    vm = rv32i_vm(spec)
    memory_init = []
    if isinstance(program, (bytes, bytearray)):
        program, memory_init, entry = decode_elf(bytes(program))
        if not program:
            raise ValueError("the ELF file has no executable section")
        if entry != min(i.address for i in program):
            raise ValueError(f"ELF entry {entry:#x} is not the first "
                             "instruction, where the tracer starts")

    state = {"pre": None, "srs_len": 0}

    def _preprocess(n: int, bytecode_rows):
        n = max(n, 1 << min_srs_log2)
        if state["pre"] is None or state["srs_len"] < n:
            scheme = HyperKZG.setup(n, device=dev) if pcs == "hyperkzg" \
                else MockCommitmentScheme(vm.spec)
            state["pre"] = vm.preprocess(bytecode_rows, scheme, device=dev)
            state["srs_len"] = n
        return state["pre"]

    def prove(inputs: bytes = b"") -> tuple[bytes, ProveArtifacts]:
        if memory_init:
            raise ValueError(
                f"the ELF file initializes {len(memory_init)} bytes of "
                "memory; the tracer and prover take no memory image")
        steps, io, bytecode_rows = trace_program(program, vm, inputs=inputs)
        pre = _preprocess(vm.required_srs_len(io, steps, bytecode_rows),
                          bytecode_rows)
        proof, commitments, _, _ = vm.prove(io, steps, pre)
        outputs = bytes(io.outputs)
        return outputs, ProveArtifacts(proof, commitments, outputs,
                                       len(steps))

    def verify(artifacts: ProveArtifacts) -> bool:
        """True, or raises VerificationError."""
        if state["pre"] is None:
            raise RuntimeError("prove() must run first: it builds the "
                               "shared preprocessing")
        vm.verify(state["pre"], artifacts.proof, artifacts.commitments)
        return True

    return prove, verify


def proof_to_bytes(artifacts: ProveArtifacts) -> bytes:
    """The canonical bytes of a HyperKZG proof and its commitments."""
    return serialize_jolt_proof_with_commitments(artifacts.proof,
                                                 artifacts.commitments)


def proof_from_bytes(data: bytes) -> ProveArtifacts:
    """`proof_to_bytes`'s inverse: artifacts that `verify` takes."""
    proof, commitments = deserialize_jolt_proof_with_commitments(data)
    return ProveArtifacts(proof, commitments, bytes(proof.program_io.outputs),
                          proof.trace_length)


def ark_proof_bytes(artifacts: ProveArtifacts) -> bytes:
    """The arkworks bytes of an rv32i_vm() HyperKZG proof and its
    commitments (rv32i_vm.rs:226-233)."""
    vm = rv32i_vm()
    proof = artifacts.proof
    # one primary-sumcheck opening per memory
    m = len(proof.instruction_lookups.primary_sumcheck.openings
            .E_poly_openings)
    return serialize_jolt_hyperkzg_proof(
        proof, artifacts.commitments["read_write"],
        artifacts.commitments["init_final"], vm.commit_layout(m), vm.C, m,
        len(vm.instruction_classes))
