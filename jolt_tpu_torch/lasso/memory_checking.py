"""Offline memory checking framework (reference: lasso/memory_checking.rs).

Protocol per memory: Reed-Solomon fingerprint the (a, v, t) access tuples
with challenges (gamma, tau), then prove via two batched grand products that
  init * write == final * read   (multiset equality)
Read/write circuits are batched together (one leaf tensor [16, 2m, T],
interleaved [read_0, write_0, read_1, write_1, ...]), likewise init/final.

Fork parity: the reference fork disables the opening accumulation and the
fingerprint checks in prove and verify (memory_checking.rs:330-384,
546-586 are commented out); only the multiset-hash consistency check and
the two grand-product verifications remain, and the proof's openings stay
default (None).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..field.host import FElt
from ..field.spec import FieldSpec, fr_spec
from ..subprotocols.grand_product import (BatchedDenseGrandProduct,
                                          BatchedGrandProductProof,
                                          default_verify_sumcheck_claim,
                                          verify_grand_product)
from ..subprotocols.sumcheck import VerificationError
from ..transcript import Transcript


@dataclass
class MultisetHashes:
    read_hashes: list[FElt]
    write_hashes: list[FElt]
    init_hashes: list[FElt]
    final_hashes: list[FElt]

    def append_to_transcript(self, transcript: Transcript) -> None:
        transcript.append_scalars(self.read_hashes)
        transcript.append_scalars(self.write_hashes)
        transcript.append_scalars(self.init_hashes)
        transcript.append_scalars(self.final_hashes)

    def check_multiset_equality(self) -> None:
        for r, w, i, f in zip(self.read_hashes, self.write_hashes,
                              self.init_hashes, self.final_hashes):
            if i * w != f * r:
                raise VerificationError("multiset hashes don't match")


@dataclass
class MemoryCheckingProof:
    multiset_hashes: MultisetHashes
    read_write_grand_product: BatchedGrandProductProof
    init_final_grand_product: BatchedGrandProductProof
    openings: object = None
    exogenous_openings: object = None


def uninterleave_hashes(read_write: list[FElt], init_final: list[FElt]
                        ) -> MultisetHashes:
    return MultisetHashes(
        read_hashes=read_write[0::2], write_hashes=read_write[1::2],
        init_hashes=init_final[0::2], final_hashes=init_final[1::2])


def interleave_hashes(h: MultisetHashes) -> tuple[list[FElt], list[FElt]]:
    rw = [x for pair in zip(h.read_hashes, h.write_hashes) for x in pair]
    inf = [x for pair in zip(h.init_hashes, h.final_hashes) for x in pair]
    return rw, inf


class MemoryCheckingProver:
    """Subclasses provide leaves + naming; the framework drives the protocol.

    Subclass interface:
      compute_leaves(polynomials, gamma, tau) -> (rw_leaves, if_leaves)
        device tensors [16, 2m, n] interleaved read/write (resp. init/final)
      protocol_name() -> bytes
    """

    spec: FieldSpec = fr_spec()

    def protocol_name(self) -> bytes:
        raise NotImplementedError

    def compute_leaves(self, polynomials, gamma: FElt, tau: FElt):
        raise NotImplementedError

    def read_write_grand_product(self, polynomials, rw_leaves):
        circuit = BatchedDenseGrandProduct.construct(rw_leaves, self.spec)
        return circuit, circuit.claims()

    def init_final_grand_product(self, polynomials, if_leaves):
        circuit = BatchedDenseGrandProduct.construct(if_leaves, self.spec)
        return circuit, circuit.claims()

    def prove_memory_checking(self, polynomials,
                              transcript: Transcript) -> MemoryCheckingProof:
        gamma = transcript.challenge_scalar()
        tau = transcript.challenge_scalar()
        transcript.append_protocol_name(self.protocol_name())

        rw_leaves, if_leaves = self.compute_leaves(polynomials, gamma, tau)
        rw_circuit, rw_hashes = self.read_write_grand_product(polynomials,
                                                              rw_leaves)
        if_circuit, if_hashes = self.init_final_grand_product(polynomials,
                                                              if_leaves)

        multiset_hashes = uninterleave_hashes(rw_hashes, if_hashes)
        multiset_hashes.check_multiset_equality()
        multiset_hashes.append_to_transcript(transcript)

        rw_proof, self.r_read_write = rw_circuit.prove(transcript)
        if_proof, self.r_init_final = if_circuit.prove(transcript)

        # Fork parity: openings stay default, no accumulator appends.
        return MemoryCheckingProof(multiset_hashes, rw_proof, if_proof)

    # -- verifier ----------------------------------------------------------
    def verify_memory_checking(self, proof: MemoryCheckingProof,
                               transcript: Transcript) -> None:
        transcript.challenge_scalar()   # gamma
        transcript.challenge_scalar()   # tau
        transcript.append_protocol_name(self.protocol_name())

        proof.multiset_hashes.check_multiset_equality()
        proof.multiset_hashes.append_to_transcript(transcript)
        rw_hashes, if_hashes = interleave_hashes(proof.multiset_hashes)

        claims_rw, r_rw = verify_grand_product(
            proof.read_write_grand_product, rw_hashes, transcript,
            verify_sumcheck_claim=default_verify_sumcheck_claim)
        claims_if, r_if = verify_grand_product(
            proof.init_final_grand_product, if_hashes, transcript)

        # Fork parity: opening appends, verifier-computed openings and
        # fingerprint checks are disabled (memory_checking.rs:546-586).
        self.verifier_claims = (claims_rw, r_rw, claims_if, r_if)


def fingerprint(a: FElt, v: FElt, t: FElt, gamma: FElt, tau: FElt) -> FElt:
    """Default (a, v, t) fingerprint: t*gamma^2 + v*gamma + a - tau."""
    return t * gamma * gamma + v * gamma + a - tau
