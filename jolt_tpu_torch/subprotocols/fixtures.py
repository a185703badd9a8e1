"""The frozen reference proof of the Quarks hybrid grand product with
HyperKZG in `fixtures/port/quark_hyperkzg.npz`: its case, its inputs and
the arrays the proof is kept in.

scripts/freeze_port_fixtures.py proves the case with jolt_tpu and writes
the file; tests/test_torch_quarks.py and chip_smoke.py prove it with the
port and compare.  The array builder reads `state_history`, points'
`.x`/`.y`/`.is_infinity` and the canonical bytes only, so it takes either
package's transcript and proof.

The case: B = 2 circuits of 2^6 leaves in [1, 2^63) from
numpy.random.default_rng(9), HyperKZG over a 2^8-point SRS (seed
0x6A6F6C74), `QuarkGrandProduct.construct(...).prove_grand_product`, then
the opening accumulator's reduce_and_prove, on one transcript labelled
b"test_transcript".  Its arrays: `states` (uint8 [events + 1, 32]), the g
commitments as x || y (uint8 [B, 64]), `gp_bytes`, the canonical bytes of
`serialize_grand_product` (uint8), and their SHA-256 (uint8 [32]).
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..convert import points_to_numpy

QUARK_B, QUARK_N, QUARK_SEED = 2, 1 << 6, 9
QUARK_SRS_LEN = 1 << 8
QUARK_LABEL = b"test_transcript"


def quark_leaves_u64() -> np.ndarray:
    """uint64 [B, n] leaves of the case."""
    rng = np.random.default_rng(QUARK_SEED)
    return rng.integers(1, 1 << 63, size=(QUARK_B, QUARK_N), dtype=np.uint64)


def quark_arrays(transcript, proof, gp_bytes: bytes) -> dict:
    return {"states": np.frombuffer(b"".join(transcript.state_history),
                                    np.uint8).reshape(-1, 32),
            "g_com": points_to_numpy([c.point for c in
                                      proof.quark.g_commitment]),
            "gp_bytes": np.frombuffer(gp_bytes, np.uint8),
            "gp_sha256": np.frombuffer(hashlib.sha256(gp_bytes).digest(),
                                       np.uint8)}


def prove_quark_case(device):
    """The port's proof of the case on `device`: (arrays, proof, reduced
    opening proof, claims, pcs)."""
    from ..commitment.hyperkzg import HyperKZG
    from ..field import device as fd
    from ..field.spec import fr_spec
    from ..poly.opening_proof import ProverOpeningAccumulator
    from ..transcript import Transcript
    from ..utils.serialization import Writer, serialize_grand_product
    from .grand_product_quarks import QuarkGrandProduct

    spec = fr_spec()
    leaves = fd.u64_to_mont_device(spec, quark_leaves_u64(), device)
    pcs = HyperKZG.setup(QUARK_SRS_LEN, device=device)
    gp = QuarkGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t = Transcript(QUARK_LABEL)
    acc = ProverOpeningAccumulator(spec)
    proof, _ = gp.prove_grand_product(acc, t, pcs)
    reduced = acc.reduce_and_prove(pcs, t)
    w = Writer()
    serialize_grand_product(w, proof)
    return quark_arrays(t, proof, w.getvalue()), proof, reduced, claims, pcs
