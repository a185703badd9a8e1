"""Fixture generators for the Solidity verifier (evm_verifier/), from the
port's provers (jolt_tpu/evm/fixtures.py).

Reference: jolt-evm-verifier/script/src/bin/{transcript,grand_product,
hyperkzg,hyperkzg_batch}_example.rs, Rust binaries that emit proof and
transcript fixtures for forge tests.  Here the generators are Python and
emit JSON, field for field what jolt_tpu's emit: fixtures/evm/*.json.
evm/solidity_vm.py executes the Solidity verifier on them.

The provers run on `device` (default: the CUDA card; device="cpu" runs
the kernels' plain versions).
"""
from __future__ import annotations

import json
import os

import numpy as np

from .._device import resolve_device
from ..field import device as fd
from ..field.host import FElt
from ..field.spec import fr_spec
from ..transcript import Transcript


def transcript_fixture() -> dict:
    """A fixed transcript event sequence with its expected states and
    challenges (transcript_example.rs)."""
    spec = fr_spec()
    t = Transcript(b"test_transcript")
    events = []
    t.append_u64(42)
    events.append({"op": "append_u64", "value": 42})
    t.append_scalar(FElt(123456789, spec))
    events.append({"op": "append_scalar", "value": hex(123456789)})
    t.append_scalars([FElt(1, spec), FElt(2, spec), FElt(3, spec)])
    events.append({"op": "append_scalars", "values": ["0x1", "0x2", "0x3"]})
    c1 = t.challenge_scalar()
    events.append({"op": "challenge_scalar", "expected": hex(c1.v)})
    cv = t.challenge_vector(4)
    events.append({"op": "challenge_vector",
                   "expected": [hex(c.v) for c in cv]})
    return {
        "label": "test_transcript",
        "events": events,
        "state_history": [s.hex() for s in t.state_history],
    }


def grand_product_fixture(nv: int = 5, batch: int = 2, seed: int = 9,
                          device=None) -> dict:
    """A batched GKR grand product proof and its claims
    (grand_product_example.rs): `batch` circuits of 2^nv leaves in
    [1, 2^63) from default_rng(seed)."""
    from ..subprotocols.grand_product import BatchedDenseGrandProduct

    spec = fr_spec()
    rng = np.random.default_rng(seed)
    vals = rng.integers(1, 1 << 63, size=(batch, 1 << nv), dtype=np.uint64)
    leaves = fd.u64_to_mont_device(spec, vals, resolve_device(device))
    gp = BatchedDenseGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t = Transcript(b"test_transcript")
    proof, r = gp.prove(t)
    return {
        "claims": [hex(c.v) for c in claims],
        "layers": [{
            "sumcheck": [[hex(c.v) for c in p.coeffs_except_linear_term]
                         for p in layer.proof.compressed_polys],
            "left_claims": [hex(c.v) for c in layer.left_claims],
            "right_claims": [hex(c.v) for c in layer.right_claims],
        } for layer in proof.layers],
        "r_grand_product": [hex(x.v) for x in r],
    }


def hyperkzg_fixture(ell: int = 4, seed: int = 7, device=None) -> dict:
    """A HyperKZG commit, open and verify instance (hyperkzg_example.rs):
    2^ell values in [1, 2^63) and a point of values below 2^62, from
    default_rng(seed)."""
    from ..commitment.hyperkzg import HyperKZG
    from ..poly.mle import evaluate_host, mle_to_felts

    spec = fr_spec()
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << ell
    pcs = HyperKZG.setup(n, device=dev)
    poly = fd.u64_to_mont_device(
        spec, rng.integers(1, 1 << 63, size=n, dtype=np.uint64), dev)
    point = [FElt(int(rng.integers(1, 1 << 62)), spec) for _ in range(ell)]
    opening = evaluate_host(list(mle_to_felts(spec, poly)), point)

    t = Transcript(b"test_transcript")
    proof = pcs.prove(poly, point, t)
    commitment = pcs.commit(poly)

    def pt(p):
        return {"x": hex(p.x), "y": hex(p.y)} if not p.is_infinity \
            else {"x": "0x0", "y": "0x0"}

    return {
        "vk": {"g1": pt(pcs.vk.g1),
               "g2": {"x": [hex(c) for c in pcs.vk.g2.x],
                      "y": [hex(c) for c in pcs.vk.g2.y]},
               "beta_g2": {"x": [hex(c) for c in pcs.vk.beta_g2.x],
                           "y": [hex(c) for c in pcs.vk.beta_g2.y]}},
        "commitment": pt(commitment.point),
        "point": [hex(x.v) for x in point],
        "opening": hex(opening.v),
        "proof": {"com": [pt(p) for p in proof.com],
                  "w": [pt(p) for p in proof.w],
                  "v": [[hex(x.v) for x in row] for row in proof.v]},
    }


def spartan_fixture(n: int = 4, device=None, mesh=None) -> dict:
    """A standalone uniform-Spartan proof over a real fibonacci(n) trace on
    rv32i_vm() (autogenerate_r1cs.rs / SpartanVerifier.t.sol).

    Captures the R1CS instance from a VM prove with the mock PCS (by
    swapping vm/r1cs.py's `spartan_prove`, which the VM looks up there),
    then re-proves the Spartan part on a fresh `test_transcript`, so that
    the Solidity SpartanVerifier can replay it alone, and checks it with
    the port's spartan_verify before returning it.  With `mesh`, both
    proves run on it (parallel/sharding.py)."""
    from ..commitment.mock import MockCommitmentScheme
    from ..poly.opening_proof import (ProverOpeningAccumulator,
                                      VerifierOpeningAccumulator)
    from ..utils.math import log2_strict
    from ..vm import host as vm_host
    from ..vm import r1cs as r1cs_mod
    from ..vm.rv32i_vm import rv32i_vm

    spec = fr_spec()
    vm = rv32i_vm(spec)
    steps, io, bytecode_rows = vm_host.trace_program(
        vm_host.fibonacci_program(n), vm)
    pcs = MockCommitmentScheme(spec)
    pre = vm.preprocess(bytecode_rows, pcs, device=resolve_device(device))

    captured = {}
    original = r1cs_mod.spartan_prove

    def capture(builder, non_uniform, key, polys, T, acc, transcript, sp,
                mesh=None):
        captured.update(builder=builder, non_uniform=non_uniform, key=key,
                        polys=polys, T=T)
        return original(builder, non_uniform, key, polys, T, acc,
                        transcript, sp, mesh=mesh)

    r1cs_mod.spartan_prove = capture
    try:
        vm.prove(io, steps, pre, mesh=mesh)
    finally:
        r1cs_mod.spartan_prove = original

    t = Transcript(b"test_transcript")
    acc = ProverOpeningAccumulator(spec)
    proof = original(captured["builder"], captured["non_uniform"],
                     captured["key"], captured["polys"], captured["T"],
                     acc, t, spec, mesh=mesh)

    vt = Transcript(b"test_transcript")
    vt.compare_to(t)
    r1cs_mod.spartan_verify(proof, captured["key"], None,
                            VerifierOpeningAccumulator(pcs, spec), vt, spec)

    sp = lambda cp: [hex(c.v) for c in cp.coeffs_except_linear_term]
    return {
        "steps_bits": log2_strict(captured["T"]),
        "outer_sumcheck": [sp(p) for p in
                           proof.outer_sumcheck_proof.compressed_polys],
        "outer_claims": [hex(c.v) for c in proof.outer_sumcheck_claims],
        "inner_sumcheck": [sp(p) for p in
                           proof.inner_sumcheck_proof.compressed_polys],
        "claimed_witness_evals": [hex(c.v)
                                  for c in proof.claimed_witness_evals],
    }


FIXTURES = {"transcript": transcript_fixture,
            "grand_product": grand_product_fixture,
            "hyperkzg": hyperkzg_fixture,
            "spartan": spartan_fixture}


def generate_all(device=None) -> dict:
    """{name: fixture} of all four generators, the provers on `device`."""
    dev = resolve_device(device)
    return {name: fn() if name == "transcript" else fn(device=dev)
            for name, fn in FIXTURES.items()}


def write_fixtures(out_dir: str, device=None) -> None:
    """Write each fixture to `out_dir`/<name>.json, as jolt_tpu writes
    fixtures/evm/."""
    fixtures = generate_all(device)
    os.makedirs(out_dir, exist_ok=True)
    for name, fx in fixtures.items():
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(fx, f, indent=1)
