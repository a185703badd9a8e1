"""The frozen reference proofs of the Quarks hybrid grand product in
`fixtures/port/`: their cases, their inputs and the form a proof is kept
in.

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

The mock cases, `QUARK_MOCK_CASES`, kept in `fixtures/port/quark_mock.json`:
B = 2 circuits of leaves from `mock_leaves_u64`, the mock PCS, quark_prove
alone or the hybrid, then the opening accumulator's reduce_and_prove.
Each case keeps its transcript states (hex), and its proof, claims,
reduced sumcheck claims and challenges as `plain` nested lists of ints.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..convert import points_to_numpy

QUARK_B, QUARK_N, QUARK_SEED = 2, 1 << 6, 9
QUARK_SRS_LEN = 1 << 8
QUARK_LABEL = b"test_transcript"
# name: (quark_prove alone or the hybrid, log2 leaves, seed)
QUARK_MOCK_CASES = {"hybrid_2^3": ("hybrid", 3, 11),
                    "hybrid_2^6": ("hybrid", 6, 9),
                    "quark_2^5": ("quark", 5, 9)}


def mock_leaves_u64(log_n: int, seed: int) -> np.ndarray:
    """uint64 [2, 2^log_n] leaves in [1, 2^63) of a mock case."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 1 << 63, size=(2, 1 << log_n), dtype=np.uint64)


def plain(x):
    """A proof as nested lists of ints, for either package's objects, in
    the form JSON keeps it (tuples as lists)."""
    if hasattr(x, "v") and hasattr(x, "spec"):
        return x.v
    if hasattr(x, "is_infinity") and hasattr(x, "x"):
        return ["point", x.x, x.y, x.is_infinity]
    if isinstance(x, (list, tuple)):
        return [plain(y) for y in x]
    if isinstance(x, int) or x is None:
        return x
    return {k: plain(v) for k, v in vars(x).items()}


def mock_record(out: dict) -> dict:
    """The kept form of one mock case's outputs (`states`, `proof`,
    `claims`, `reduced`, and `r` or `r_t` and `h_r_t`)."""
    rec = {k: plain(v) for k, v in out.items()
           if k not in ("states", "reduced", "acc")}
    rec["reduced"] = plain(out["reduced"].sumcheck_claims)
    rec["states"] = [s.hex() for s in out["states"]]
    return rec


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
