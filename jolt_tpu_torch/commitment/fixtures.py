"""The frozen reference openings of Zeromorph and Hyrax in `fixtures/port/`:
their cases, their inputs, and the arrays an opening is kept in.

scripts/freeze_port_fixtures.py runs each case with jolt_tpu and writes
`fixtures/port/zeromorph_l6.npz` and `fixtures/port/hyrax_l7.npz`; the
port's tests run the same cases with the port and compare the arrays.  The
array builders read `state_history`, `.x`/`.y`/`.is_infinity` and `.v`
only, so they take either package's transcript, commitments and proofs.

Inputs come from numpy's default_rng, seeded per case: uniform field
elements for Zeromorph's polynomials, for Hyrax's at ell = 3 and for every
opening point; values below 2^63 (the pcs-bench draw) for Hyrax's larger
polynomials, whose row commitments then need 8 windows, not 32.  Each
case's arrays: the transcript's `state_history` (uint8 [events + 1, 32]),
points as x || y (uint8 [k, 64]) and scalars (uint8 [k, 32]), as
convert.py writes them.
"""
from __future__ import annotations

import numpy as np

from ..convert import (points_to_numpy, scalars_to_numpy,
                       zeromorph_proof_to_numpy)
from ..field.spec import fr_spec

P = fr_spec().p
ZEROMORPH_ELLS = (3, 6)
ZEROMORPH_LABEL = b"zm"
HYRAX_CASES = ((3, 1), (3, 4), (6, 1), (6, 4), (7, 1), (7, 4))  # (ell, ratio)
HYRAX_LABEL = b"hx"
HYRAX_BATCH_ELL, HYRAX_BATCH_K = 6, 4     # four polynomials, BatchType.SMALL
HYRAX_BATCH_LABEL = b"hxb"


def field_ints(rng: np.random.Generator, *shape) -> np.ndarray:
    """Uniform field elements (four 62-bit words each, reduced) as Python
    ints in a numpy object array of `shape`."""
    w = rng.integers(0, 1 << 62, size=shape + (4,), dtype=np.uint64)
    out = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        a, b, c, d = (int(x) for x in w[idx])
        out[idx] = (a | b << 62 | c << 124 | d << 186) % P
    return out


def u63_ints(rng: np.random.Generator, n: int) -> list[int]:
    """n values in [1, 2^63), as cli.py pcs-bench draws them."""
    return [int(v) for v in rng.integers(1, 1 << 63, size=n,
                                         dtype=np.uint64)]


def zeromorph_inputs(ell: int) -> tuple[list[int], list[int]]:
    """(evaluations, opening point) of the Zeromorph case at ell."""
    rng = np.random.default_rng(0x5A00 + ell)
    return field_ints(rng, 1 << ell), field_ints(rng, ell)


def hyrax_inputs(ell: int, ratio: int) -> tuple[list[int], list[int]]:
    rng = np.random.default_rng(0x4800 + 16 * ell + ratio)
    vals = field_ints(rng, 1 << ell) if ell <= 3 else u63_ints(rng, 1 << ell)
    return vals, field_ints(rng, ell)


def hyrax_batch_inputs() -> tuple[list[list[int]], list[int]]:
    """(K evaluation vectors, opening point) of the batched case."""
    rng = np.random.default_rng(0x4842)
    polys = [u63_ints(rng, 1 << HYRAX_BATCH_ELL) for _ in range(HYRAX_BATCH_K)]
    return polys, field_ints(rng, HYRAX_BATCH_ELL)


def states(transcript) -> np.ndarray:
    return np.frombuffer(b"".join(transcript.state_history),
                         np.uint8).reshape(-1, 32)


def zeromorph_arrays(ell: int, transcript, commitment, proof) -> dict:
    arrays = {"states": states(transcript),
              "com": points_to_numpy([commitment.point]),
              **zeromorph_proof_to_numpy(proof)}
    return {f"zm{ell}_{k}": v for k, v in arrays.items()}


def hyrax_arrays(ell: int, ratio: int, transcript, commitment,
                 proof) -> dict:
    pre = f"hx{ell}_{ratio}_"
    return {pre + "states": states(transcript),
            pre + "rows": points_to_numpy(commitment.row_commitments),
            pre + "vmp": scalars_to_numpy(proof.vector_matrix_product)}


def hyrax_batch_arrays(transcript, commitments, proof) -> dict:
    return {"hxb_states": states(transcript),
            "hxb_rows": np.stack([points_to_numpy(c.row_commitments)
                                  for c in commitments]),
            "hxb_vmp": scalars_to_numpy(
                proof.joint_proof.vector_matrix_product),
            "hxb_ratio": np.int64(proof.ratio)}


def prove_port_cases(device) -> dict:
    """The port's arrays of every case of both files, on `device` (what
    chip_smoke.py holds against the frozen files on the card)."""
    from ..field.host import FElt
    from ..poly.mle import evaluate_host, mle_from_ints
    from ..transcript import Transcript
    from .base import BatchType
    from .hyrax import HyraxScheme, PedersenGenerators
    from .zeromorph import Zeromorph

    spec = fr_spec()
    felts = lambda xs: [FElt(x, spec) for x in xs]
    out = {}
    zm = Zeromorph.setup(1 << max(ZEROMORPH_ELLS), device=device)
    for ell in ZEROMORPH_ELLS:
        vals, point = zeromorph_inputs(ell)
        poly = mle_from_ints(spec, vals, device)
        t = Transcript(ZEROMORPH_LABEL)
        proof = zm.prove(poly, felts(point), t)
        out.update(zeromorph_arrays(ell, t, zm.commit(poly), proof))
    hx = HyraxScheme(PedersenGenerators.new(1 << 4, device=device))
    for ell, ratio in HYRAX_CASES:
        vals, point = hyrax_inputs(ell, ratio)
        poly = mle_from_ints(spec, vals, device)
        t = Transcript(HYRAX_LABEL)
        proof = hx.prove(poly, felts(point), t, ratio)
        out.update(hyrax_arrays(ell, ratio, t, hx.commit(poly, ratio), proof))
    all_vals, point = hyrax_batch_inputs()
    polys = [mle_from_ints(spec, v, device) for v in all_vals]
    t = Transcript(HYRAX_BATCH_LABEL)
    openings = [evaluate_host(felts(v), felts(point)) for v in all_vals]
    proof = hx.prove_batched(polys, felts(point), openings, t,
                             BatchType.SMALL)
    out.update(hyrax_batch_arrays(t, hx.batch_commit(polys), proof))
    return out
