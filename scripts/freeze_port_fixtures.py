#!/usr/bin/env python3
"""Freeze jolt_tpu's proof transcripts for the port's tests.

    JAX_PLATFORMS=cpu python scripts/freeze_port_fixtures.py [CASE ...]

With no CASE, freezes them all.  Each case is proved and verified by
jolt_tpu on the CPU and written to `fixtures/port/<case>.npz`:

    fib3_mock      fibonacci(3) on the mini VM (ADD, BNE over
                   TruncateOverflow(32), Identity, Eq; C = 4, M = 2^8,
                   32-byte I/O), the mock PCS
    fib3_hyperkzg  the same, HyperKZG over a 2^8-point SRS (seed 0x6A6F6C74)
    fib3_parity    the same as fib3_mock with JOLT_REFERENCE_PARITY=1 (the
                   reference's SHA3 vk_digest)
    narrow_mock    `narrow_program` on the narrow VM (the 23 RV32I
                   instructions that chunk at M = 2^8, all 26 subtables;
                   C = 4, M = 2^8, 32-byte I/O), the mock PCS
    rv32i_fib8_mock    fibonacci(8) on rv32i_vm() (C = 4, M = 2^16), the
                       mock PCS: jolt_tpu's tests/test_rv32i_e2e.py
    rv32i_muldiv_mock  `muldiv_mix_program` on rv32i_vm(), the mock PCS:
                       the same test file's M-extension program
    rv32i_loadstore_mock  `loadstore_program` on rv32i_vm(), the mock PCS:
                       every load and store width, and LUI
    rv32i_sha2_1_mock  sha2_chain_program(1) on rv32i_vm() (5,161 steps,
                       T = 2^13), the mock PCS
    rv32i_multifn4_mock  multi_function_program(4) on rv32i_vm(), the mock
                       PCS: JAL calls and JALR returns at full width
    rv32i_loadstore_hyperkzg  `loadstore_program` on rv32i_vm(), HyperKZG
                       over the 2^16-point SRS fixture; adds the SHA-256
                       and length of the proof's arkworks bytes
    jolt_parts     jolt_tpu's side of tests/test_torch_jolt_parts.py (the
                   toggled grand product, the opening reduction, HyperKZG's
                   and KZG's openings at ell = 6, the MLE helpers) on the
                   inputs of `parts_inputs`
    zeromorph_l6   Zeromorph (SRS seed 0x5A4D) opened at ell = 3 and 6:
                   transcript, commitment and every proof element
    hyrax_l7       Hyrax at ell = 3, 6, 7 and ratios 1 and 4, and a
                   BatchedHyraxOpeningProof of four polynomials at ell = 6:
                   transcripts, row commitments and vector-matrix products
                   (both cases: jolt_tpu_torch/commitment/fixtures.py;
                   run with JOLT_TPU_SRS_CACHE=0, which this script sets,
                   so that jolt_tpu writes no SRS into fixtures/srs/)
    quark_hyperkzg the Quarks hybrid grand product (B = 2, 2^6 leaves) with
                   HyperKZG over a 2^8-point SRS: transcript, g commitments
                   and the canonical bytes of the grand-product proof
                   (jolt_tpu_torch/subprotocols/fixtures.py)
    quark_mock     jolt_tpu's side of tests/test_torch_quarks.py's mock cases
                   (quark_prove alone and the hybrid, B = 2, 2^3-2^6
                   leaves): transcripts, proofs, claims and challenges, as
                   fixtures/port/quark_mock.json
    fib3_spans     jolt_tpu's profiling spans (name, calls, ops) of the
                   fib3_mock preprocessing and prove, as
                   fixtures/port/fib3_spans.json
    fib3_proof_bytes   the three fib3 proofs' `proof_size_bytes`, and the
                       HyperKZG one's canonical and arkworks bytes (SHA-256
                       and length), as fixtures/port/fib3_proof_bytes.json
                       (jolt_tpu's byte serializers read HyperKZG points and
                       opening proofs, which the mock PCS has not)
    fib3_spans_chain   as fib3_spans, with jolt_tpu's device Fiat-Shamir
                       and chained grand products on (FS_DEVICE_ENV), as
                       fixtures/port/fib3_spans_chain.json
    fs_device      jolt_tpu's side of tests/test_torch_fs_device.py, with
                   FS_DEVICE_ENV: three chained fs_cubic_round_jit rounds
                   (compressed polys, challenges, claims, states), the
                   chained dense grand product (B = 2, 8 leaves) and the
                   chained toggled one (2 flag rows, T = 8): transcripts,
                   challenges, claims, and their span rows
    mesh           jolt_tpu's side of tests/test_torch_sharding.py, on the
                   inputs of `mesh_inputs`, unsharded (the sharded port
                   must reproduce it): prove_arbitrary and
                   prove_arbitrary_bot (n = 128, degree 3), the dense
                   grand product (B = 11, 16 leaves) and Surge XOR (C = 2,
                   M = 2^4, 16 lookups): transcripts, challenges, claims
    fs_degree      jolt_tpu's prove_arbitrary at degree 9 and 12 (the
                   product of 9 and 12 MLEs over 2^3 points), for
                   tests/test_torch_fs_device.py's degree cases

The cases, their programs and the array format are in
jolt_tpu_torch/vm/fixtures.py, which the port's tests and chip_smoke.py
read too; tests/test_torch_vm.py and tests/test_torch_rv32i.py compare the
port's proofs with these files, and their `slow` tests rerun `prove_case`
and `prove_rv32i_case` live.  A fib3 prove takes minutes of XLA compiles,
an rv32i one longer.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
OUT_DIR = ROOT / "fixtures" / "port"
sys.path.insert(0, str(ROOT))
from jolt_tpu_torch.commitment.fixtures import field_ints  # noqa: E402
from jolt_tpu_torch.vm import fixtures as fx  # noqa: E402

CASES = ("mock", "hyperkzg", "parity")
PCS_CASES = ("zeromorph_l6", "hyrax_l7")
# jolt_tpu's device Fiat-Shamir on the CPU, with its device rounds down to
# the last (no host tail): the mode the port's device path is held to
FS_DEVICE_ENV = {"JOLT_TPU_DEVICE_FS": "1", "JOLT_TPU_CHAIN": "1",
                 "JOLT_TPU_HOST_TAIL": "0"}


@contextlib.contextmanager
def env(values: dict):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ark_bytes(vm, pre, proof, commitments) -> bytes:
    """jolt_tpu's arkworks `JoltHyperKZGProof` bytes of a HyperKZG proof."""
    from jolt_tpu.utils.ark_proof import serialize_jolt_hyperkzg_proof
    il = pre.instruction_lookups
    return serialize_jolt_hyperkzg_proof(
        proof, commitments["read_write"], commitments["init_final"],
        vm.commit_layout(il.num_memories), il.C, il.num_memories,
        il.num_instructions)


def prove_rv32i_case(case: str) -> dict:
    """jolt_tpu's proof of `narrow_mock` or one of RV32I_CASES and
    RV32I_HYPERKZG_CASES, verified by jolt_tpu, as the arrays above (mock
    commitments as digests)."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import fr_spec
    from jolt_tpu.instructions import RV32I_INSTRUCTIONS
    from jolt_tpu.vm.guests import (_Asm, multi_function_program,
                                    sha2_chain_program)
    from jolt_tpu.vm.host import fibonacci_program, trace_program
    from jolt_tpu.vm.rv32i_vm import RV32I_SUBTABLES, mini_vm, rv32i_vm
    from jolt_tpu.vm.rv_trace import RV32IM

    spec = fr_spec()
    io_size = {}
    if case == "narrow_mock":
        vm = mini_vm(fx.narrow_instructions(RV32I_INSTRUCTIONS),
                     RV32I_SUBTABLES, M_mini=fx.M_MINI, spec=spec)
        io_size = dict(max_input_size=32, max_output_size=32)
    else:
        vm = rv32i_vm(spec)
    program, inputs = fx.case_program(case, _Asm, RV32IM, fibonacci_program,
                                      sha2_chain_program,
                                      multi_function_program)
    steps, io, rows = trace_program(program, vm, inputs=inputs, native=False,
                                    **io_size)
    hyperkzg = case in fx.RV32I_HYPERKZG_CASES
    pcs = HyperKZG.setup(vm.required_srs_len(io, steps, rows)) if hyperkzg \
        else MockCommitmentScheme(spec)
    pre = vm.preprocess(rows, pcs)
    proof, commitments, transcript, acc = vm.prove(io, steps, pre)
    vm.verify(pre, proof, commitments, debug_transcript=transcript,
              debug_accumulator=acc)
    ark = ark_bytes(vm, pre, proof, commitments) if hyperkzg else None
    return fx.proof_arrays(transcript, commitments, digest=True, ark=ark)


def fib3_proof(case: str, spans: bool = False):
    """jolt_tpu's fib(3) proof of one of CASES, verified by jolt_tpu:
    (vm, preprocessing, proof, commitments, transcript).  With `spans`,
    jolt_tpu's profiling spans are on from the preprocessing to the end of
    the prove, and the result is their (name, calls, ops) rows, sorted."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import fr_spec
    from jolt_tpu.instructions import AddInstruction, BneInstruction
    from jolt_tpu.subtables.rv32i import (EqSubtable, IdentitySubtable,
                                          TruncateOverflowSubtable)
    from jolt_tpu.utils import profiling
    from jolt_tpu.vm.host import fibonacci_program, trace_program
    from jolt_tpu.vm.rv32i_vm import mini_vm

    old = os.environ.pop("JOLT_REFERENCE_PARITY", None)
    if case == "parity":
        os.environ["JOLT_REFERENCE_PARITY"] = "1"
    try:
        spec = fr_spec()
        vm = mini_vm([AddInstruction, BneInstruction],
                     [TruncateOverflowSubtable(32), IdentitySubtable(),
                      EqSubtable()], M_mini=fx.M_MINI, spec=spec)
        steps, io, rows = trace_program(fibonacci_program(fx.FIB_N), vm,
                                        max_input_size=32, max_output_size=32,
                                        native=False)
        pcs = HyperKZG.setup(fx.SRS_LEN) if case == "hyperkzg" \
            else MockCommitmentScheme(spec)
        profiling.reset()
        profiling.enable(spans)
        try:
            pre = vm.preprocess(rows, pcs)
            proof, commitments, transcript, acc = vm.prove(io, steps, pre)
        finally:
            profiling.enable(False)
        rows_out = sorted((name, calls, ops)
                          for name, calls, _, ops in profiling.cumulative())
        vm.verify(pre, proof, commitments, debug_transcript=transcript,
                  debug_accumulator=acc)
        if spans:
            return rows_out
        return vm, pre, proof, commitments, transcript
    finally:
        os.environ.pop("JOLT_REFERENCE_PARITY", None)
        if old is not None:
            os.environ["JOLT_REFERENCE_PARITY"] = old


def prove_case(case: str) -> dict:
    """jolt_tpu's fib(3) proof of one of CASES, as the arrays above."""
    _, _, _, commitments, transcript = fib3_proof(case)
    return fx.proof_arrays(transcript, commitments)


def fib3_proof_bytes() -> dict:
    """For each of CASES, jolt_tpu's `proof_size_bytes` of its fib(3)
    proof; for the HyperKZG one also the SHA-256 (hex) and length of its
    canonical `serialize_jolt_proof_with_commitments` bytes and of its
    arkworks bytes."""
    from jolt_tpu.utils.serialization import (
        proof_size_bytes, serialize_jolt_proof_with_commitments)
    out = {}
    for case in CASES:
        vm, pre, proof, commitments, _ = fib3_proof(case)
        row = {"proof_size_bytes": proof_size_bytes(proof)}
        if case == "hyperkzg":
            for key, blob in (
                    ("canonical", serialize_jolt_proof_with_commitments(
                        proof, commitments)),
                    ("ark", ark_bytes(vm, pre, proof, commitments))):
                row[f"{key}_sha256"] = hashlib.sha256(blob).hexdigest()
                row[f"{key}_len"] = len(blob)
        out[f"fib3_{case}"] = row
    return out


PARTS_ELL = 6


def parts_inputs() -> dict:
    """The numpy-seeded inputs of tests/test_torch_jolt_parts.py."""
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=(3, 16)).astype(bool)
    toggled = (bits, field_ints(rng, 6, 16))
    rng = np.random.default_rng(9)
    groups = []
    for ell in (3, 2, 3):
        point = [int(x) for x in field_ints(rng, ell)]
        groups.append((point, field_ints(rng, 2, 1 << ell)))
    rng = np.random.default_rng(13)
    hyperkzg = (field_ints(rng, 1 << PARTS_ELL),
                [int(x) for x in field_ints(rng, PARTS_ELL)])
    rng = np.random.default_rng(17)
    kzg = (field_ints(rng, 1 << PARTS_ELL), int(field_ints(rng, 1)[0]))
    rng = np.random.default_rng(21)
    mle = (field_ints(rng, 3, 16), [int(x) for x in field_ints(rng, 4)])
    return {"toggled": toggled, "openings": groups, "hyperkzg": hyperkzg,
            "kzg": kzg, "mle": mle}


def jolt_parts_arrays() -> dict:
    """jolt_tpu's outputs on `parts_inputs`: transcripts' state_history,
    claims and evaluations (uint8 [k, 32]), points (uint8 [k, 64]) and
    device limbs (uint32 [16, ...])."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.commitment import kzg as jkzg
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import FElt, fr_spec
    from jolt_tpu.field import device as jfd
    from jolt_tpu.poly import mle as jmle
    from jolt_tpu.poly.opening_proof import ProverOpeningAccumulator
    from jolt_tpu.subprotocols import grand_product as jgp
    from jolt_tpu.subprotocols import sumcheck as jsumcheck
    from jolt_tpu.transcript import Transcript
    from jolt_tpu_torch.commitment.fixtures import states
    from jolt_tpu_torch.convert import points_to_numpy, scalars_to_numpy

    spec = fr_spec()
    felts = lambda xs: [FElt(int(x), spec) for x in xs]
    dev = lambda vals: jfd.ints_to_device(spec, vals.tolist())
    limbs = lambda a: np.asarray(a).astype(np.uint32)
    inp = parts_inputs()
    out = {}

    bits, fps = inp["toggled"]
    circ = jgp.ToggledBatchedGrandProduct(bits, dev(fps), spec)
    out["gp_claims"] = scalars_to_numpy(circ.claims())
    t = Transcript(b"toggled")
    proof, r = circ.prove(t)
    out.update(gp_states=states(t), gp_r=scalars_to_numpy(r),
               gp_left=np.stack([scalars_to_numpy(lp.left_claims)
                                 for lp in proof.layers]),
               gp_right=np.stack([scalars_to_numpy(lp.right_claims)
                                  for lp in proof.layers]))

    acc, t = ProverOpeningAccumulator(spec), Transcript(b"openings")
    for point, vals in inp["openings"]:
        polys = dev(vals)
        acc.append([polys[:, i] for i in range(2)],
                   jmle.eq_evals_device(spec, point), felts(point),
                   [jmle.evaluate_host(felts(row), felts(point))
                    for row in vals], t)
    red = acc.reduce_and_prove(MockCommitmentScheme(spec), t)
    out.update(open_states=states(t),
               open_claims=scalars_to_numpy(red.sumcheck_claims))

    vals, point = inp["hyperkzg"]
    pcs = HyperKZG.setup(1 << PARTS_ELL)
    t = Transcript(b"hyperkzg")
    proof = pcs.prove(dev(vals), felts(point), t)
    out.update(hk_states=states(t), hk_com=points_to_numpy(proof.com),
               hk_w=points_to_numpy(proof.w),
               hk_v=np.stack([scalars_to_numpy(row) for row in proof.v]))

    b, u = inp["kzg"]
    w = jkzg.kzg_open_no_rem(pcs.pk, dev(b), FElt(u, spec))
    out.update(kzg_w=points_to_numpy([w]), kzg_v=scalars_to_numpy(
        [jkzg.poly_eval_device(dev(b), FElt(u, spec))]))

    vals, point = inp["mle"]
    z = dev(vals)
    eq = jmle.eq_evals_device(spec, point)
    cols = [z[:, i] for i in range(3)]
    out.update(mle_eq=limbs(eq), mle_eval=limbs(jmle.evaluate_device(
        spec, z, eq)), mle_many=scalars_to_numpy(
        jmle.evaluate_many_host(spec, cols, eq)),
        mle_from_ints=limbs(jmle.mle_from_ints(spec, vals.tolist())),
        mle_to_felts=scalars_to_numpy(jmle.mle_to_felts(spec, z).ravel()),
        comb_product=limbs(jsumcheck.comb_product(spec, cols)))
    return out


def fs_device_inputs() -> dict:
    """The numpy-seeded inputs of tests/test_torch_fs_device.py."""
    rng = np.random.default_rng(31)
    return {"gp_leaves": field_ints(rng, 2, 8),
            "tg_bits": rng.integers(0, 2, size=(2, 8)).astype(bool),
            "tg_fps": field_ints(rng, 4, 8),
            "round_evals": field_ints(rng, 3, 3),
            "round_prev": field_ints(rng, 1)}


def fs_device_arrays() -> dict:
    """jolt_tpu's outputs on `fs_device_inputs`, with FS_DEVICE_ENV:
    limbs as uint32 [16, ...], states as uint32 [8] + count, transcripts,
    challenges and claims as bytes, and the grand products' span rows (a
    JSON string)."""
    from jolt_tpu.field import fr_spec
    from jolt_tpu.field import device as jfd
    from jolt_tpu.subprotocols import fs_device as jfsd
    from jolt_tpu.subprotocols import grand_product as jgp
    from jolt_tpu.transcript import Transcript
    from jolt_tpu.utils import profiling
    from jolt_tpu_torch.commitment.fixtures import states
    from jolt_tpu_torch.convert import scalars_to_numpy

    spec = fr_spec()
    dev = lambda vals: jfd.ints_to_device(spec, vals.tolist())
    limbs = lambda a: np.asarray(a).astype(np.uint32)
    inp = fs_device_inputs()
    out = {}
    with env(FS_DEVICE_ENV):
        t = Transcript(b"fs_round")
        state, nr = jfsd.state_to_device(t)
        prev = dev(inp["round_prev"])[:, 0]
        fs_round = jfsd.fs_cubic_round_jit(spec)
        for j, e023 in enumerate(inp["round_evals"]):
            comp, rj, prev, state, nr = fs_round(dev(e023), prev, state, nr)
            out.update({f"round{j}_comp": limbs(comp),
                        f"round{j}_rj": limbs(rj),
                        f"round{j}_prev": limbs(prev),
                        f"round{j}_state": limbs(state),
                        f"round{j}_nr": limbs(nr)})
        profiling.reset()
        profiling.enable(True)
        try:
            gp = jgp.BatchedDenseGrandProduct.construct(
                dev(inp["gp_leaves"]), spec)
            tg = jgp.ToggledBatchedGrandProduct(inp["tg_bits"],
                                                dev(inp["tg_fps"]), spec)
            assert gp._chain_ok() and tg._chain_ok()
            for name, circ in (("gp", gp), ("tg", tg)):
                t = Transcript(name.encode())
                proof, r = circ.prove(t)
                out.update({
                    f"{name}_states": states(t),
                    f"{name}_r": scalars_to_numpy(r),
                    f"{name}_left": np.concatenate(
                        [scalars_to_numpy(lp.left_claims)
                         for lp in proof.layers]),
                    f"{name}_right": np.concatenate(
                        [scalars_to_numpy(lp.right_claims)
                         for lp in proof.layers])})
        finally:
            profiling.enable(False)
        out["spans"] = np.array(json.dumps(sorted(
            [name, calls, ops]
            for name, calls, _, ops in profiling.cumulative())))
    return out


def mesh_inputs() -> dict:
    """The numpy-seeded inputs of tests/test_torch_sharding.py's provers
    (canonical field ints)."""
    rng = np.random.default_rng(41)
    return {"sc_top": field_ints(rng, 3, 128),
            "sc_bot": field_ints(rng, 3, 128),
            "gp_leaves": field_ints(rng, 11, 16),
            "surge_x": rng.integers(0, 16, size=16, dtype=np.uint64),
            "surge_y": rng.integers(0, 16, size=16, dtype=np.uint64)}


def _sumcheck_record(name: str, t, r, finals) -> dict:
    from jolt_tpu_torch.commitment.fixtures import states
    from jolt_tpu_torch.convert import scalars_to_numpy
    return {f"{name}_states": states(t), f"{name}_r": scalars_to_numpy(r),
            f"{name}_finals": scalars_to_numpy(finals)}


def mesh_arrays() -> dict:
    """jolt_tpu's outputs on `mesh_inputs`, host Fiat-Shamir."""
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.field import fr_spec
    from jolt_tpu.field import device as jfd
    from jolt_tpu.instructions import XorInstruction
    from jolt_tpu.lasso import surge
    from jolt_tpu.subprotocols import grand_product as jgp
    from jolt_tpu.subprotocols import sumcheck as jsc
    from jolt_tpu.transcript import Transcript
    from jolt_tpu_torch.commitment.fixtures import states
    from jolt_tpu_torch.convert import scalars_to_numpy

    spec = fr_spec()
    dev = lambda vals: jfd.ints_to_device(spec, vals.tolist())
    inp = mesh_inputs()
    out = {}
    with env({"JOLT_TPU_DEVICE_FS": "0", "JOLT_TPU_CHAIN": "0"}):
        for name, fn in (("sc_top", jsc.prove_arbitrary),
                         ("sc_bot", jsc.prove_arbitrary_bot)):
            t = Transcript(name.encode())
            _, r, finals = fn(7, [dev(row) for row in inp[name]],
                              jsc.comb_product, 3, t, spec)
            out.update(_sumcheck_record(name, t, r, finals))
        gp = jgp.BatchedDenseGrandProduct.construct(dev(inp["gp_leaves"]),
                                                    spec)
        t = Transcript(b"gp")
        out["gp_claims"] = scalars_to_numpy(gp.claims())
        proof, r = gp.prove(t)
        out.update({"gp_states": states(t), "gp_r": scalars_to_numpy(r),
                    "gp_left": np.concatenate(
                        [scalars_to_numpy(lp.left_claims)
                         for lp in proof.layers])})
        pre = surge.SurgePreprocessing(XorInstruction, 2, 16, spec)
        _, t, _ = surge.surge_prove(pre, MockCommitmentScheme(spec),
                                    inp["surge_x"], inp["surge_y"])
        out["surge_states"] = states(t)
    return out


FS_DEGREES = (9, 12)


def fs_degree_inputs() -> dict:
    """tests/test_torch_fs_device.py's degree-9 and degree-12 sumchecks:
    the product of `degree` MLEs over 2^3 points (canonical ints)."""
    rng = np.random.default_rng(43)
    return {f"deg{d}": field_ints(rng, d, 8) for d in FS_DEGREES}


def fs_degree_arrays() -> dict:
    """jolt_tpu's prove_arbitrary on `fs_degree_inputs` (3 rounds each)."""
    from jolt_tpu.field import fr_spec
    from jolt_tpu.field import device as jfd
    from jolt_tpu.subprotocols import sumcheck as jsc
    from jolt_tpu.transcript import Transcript

    spec = fr_spec()
    out = {}
    with env({"JOLT_TPU_DEVICE_FS": "0", "JOLT_TPU_CHAIN": "0"}):
        for name, rows in fs_degree_inputs().items():
            t = Transcript(name.encode())
            _, r, finals = jsc.prove_arbitrary(
                3, [jfd.ints_to_device(spec, row.tolist()) for row in rows],
                jsc.comb_product, rows.shape[0], t, spec)
            out.update(_sumcheck_record(name, t, r, finals))
    return out


def prove_pcs_case(case: str) -> dict:
    """jolt_tpu's openings of `zeromorph_l6` or `hyrax_l7`, each verified
    by jolt_tpu, as the arrays of jolt_tpu_torch/commitment/fixtures.py."""
    from jolt_tpu.commitment.base import BatchType
    from jolt_tpu.commitment.hyrax import HyraxScheme
    from jolt_tpu.commitment.zeromorph import Zeromorph
    from jolt_tpu.field import FElt, fr_spec
    from jolt_tpu.poly import mle
    from jolt_tpu.transcript import Transcript
    from jolt_tpu_torch.commitment import fixtures as pfx

    spec = fr_spec()
    felts = lambda xs: [FElt(x, spec) for x in xs]
    out = {}
    if case == "zeromorph_l6":
        for ell in pfx.ZEROMORPH_ELLS:
            vals, point = pfx.zeromorph_inputs(ell)
            pcs = Zeromorph.setup(1 << ell)
            poly = mle.mle_from_ints(spec, vals)
            com = pcs.commit(poly)
            t = Transcript(pfx.ZEROMORPH_LABEL)
            proof = pcs.prove(poly, felts(point), t)
            pcs.verify(proof, Transcript(pfx.ZEROMORPH_LABEL), felts(point),
                       mle.evaluate_host(felts(vals), felts(point)), com)
            out.update(pfx.zeromorph_arrays(ell, t, com, proof))
        return out
    for ell, ratio in pfx.HYRAX_CASES:
        vals, point = pfx.hyrax_inputs(ell, ratio)
        pcs = HyraxScheme.setup(1 << ell, ratio)
        poly = mle.mle_from_ints(spec, vals)
        com = pcs.commit(poly, ratio)
        t = Transcript(pfx.HYRAX_LABEL)
        proof = pcs.prove(poly, felts(point), t, ratio)
        pcs.verify(proof, Transcript(pfx.HYRAX_LABEL), felts(point),
                   mle.evaluate_host(felts(vals), felts(point)), com, ratio)
        out.update(pfx.hyrax_arrays(ell, ratio, t, com, proof))
    all_vals, point = pfx.hyrax_batch_inputs()
    pcs = HyraxScheme.setup(1 << pfx.HYRAX_BATCH_ELL)
    polys = [mle.mle_from_ints(spec, v) for v in all_vals]
    coms = [pcs.commit(p) for p in polys]
    openings = [mle.evaluate_host(felts(v), felts(point)) for v in all_vals]
    t = Transcript(pfx.HYRAX_BATCH_LABEL)
    proof = pcs.prove_batched(polys, felts(point), openings, t,
                              BatchType.SMALL)
    proof.verify(pcs, felts(point), openings, coms,
                 Transcript(pfx.HYRAX_BATCH_LABEL))
    out.update(pfx.hyrax_batch_arrays(t, coms, proof))
    return out


def prove_quark_case() -> dict:
    """jolt_tpu's Quarks hybrid proof of the case of
    jolt_tpu_torch/subprotocols/fixtures.py, verified by jolt_tpu, as that
    module's arrays."""
    import jax.numpy as jnp
    from jolt_tpu.commitment.hyperkzg import HyperKZG
    from jolt_tpu.field import device as jfd
    from jolt_tpu.field import fr_spec
    from jolt_tpu.poly.opening_proof import (ProverOpeningAccumulator,
                                             VerifierOpeningAccumulator)
    from jolt_tpu.subprotocols.grand_product_quarks import QuarkGrandProduct
    from jolt_tpu.transcript import Transcript
    from jolt_tpu.utils.serialization import Writer, serialize_grand_product
    from jolt_tpu_torch.subprotocols import fixtures as sfx

    spec = fr_spec()
    leaves = jfd.to_mont_device(spec, jnp.asarray(
        jfd.pack_u64(sfx.quark_leaves_u64())))
    pcs = HyperKZG.setup(sfx.QUARK_SRS_LEN)
    gp = QuarkGrandProduct.construct(leaves, spec)
    claims = gp.claims()
    t = Transcript(sfx.QUARK_LABEL)
    acc = ProverOpeningAccumulator(spec)
    proof, _ = gp.prove_grand_product(acc, t, pcs)
    reduced = acc.reduce_and_prove(pcs, t)
    vt = Transcript(sfx.QUARK_LABEL)
    vacc = VerifierOpeningAccumulator(pcs, spec)
    QuarkGrandProduct.verify_grand_product(proof, claims, vacc, vt, spec)
    vacc.reduce_and_verify(pcs, reduced, vt)
    w = Writer()
    serialize_grand_product(w, proof)
    return sfx.quark_arrays(t, proof, w.getvalue())


def quark_mock_case(kind: str, log_n: int, seed: int) -> dict:
    """jolt_tpu's proof of one of QUARK_MOCK_CASES (the mock PCS), the
    opening accumulator reduced and proved after it, in the kept form of
    jolt_tpu_torch/subprotocols/fixtures.py."""
    import jax.numpy as jnp
    from jolt_tpu.commitment import MockCommitmentScheme
    from jolt_tpu.field import FElt, fr_spec
    from jolt_tpu.field import device as jfd
    from jolt_tpu.poly.opening_proof import ProverOpeningAccumulator
    from jolt_tpu.subprotocols.grand_product_quarks import (
        QuarkGrandProduct, quark_prove)
    from jolt_tpu.transcript import Transcript
    from jolt_tpu_torch.subprotocols import fixtures as sfx

    spec = fr_spec()
    vals = sfx.mock_leaves_u64(log_n, seed)
    leaves = jfd.to_mont_device(spec, jnp.asarray(jfd.pack_u64(vals)))
    t, acc = Transcript(sfx.QUARK_LABEL), ProverOpeningAccumulator(spec)
    pcs = MockCommitmentScheme(spec)
    if kind == "quark":
        proof, r_t, h_r_t = quark_prove(leaves, pcs, acc, t, spec)
        claims = [FElt(int(np.prod([int(v) for v in row], dtype=object)
                           % spec.p), spec) for row in vals]
        out = dict(r_t=r_t, h_r_t=h_r_t)
    else:
        gp = QuarkGrandProduct.construct(leaves, spec)
        claims = gp.claims()
        proof, r = gp.prove_grand_product(acc, t, pcs)
        out = dict(r=r)
    reduced = acc.reduce_and_prove(pcs, t)
    return sfx.mock_record(dict(out, proof=proof, claims=claims,
                                reduced=reduced, states=t.state_history))


def main(argv=None) -> None:
    os.environ["JOLT_TPU_SRS_CACHE"] = "0"   # write nothing into fixtures/srs
    import jax
    jax.config.update("jax_platforms", "cpu")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    names = [f"fib3_{c}" for c in CASES] + ["narrow_mock", *fx.RV32I_CASES,
                                            *fx.RV32I_HYPERKZG_CASES,
                                            *PCS_CASES, "jolt_parts",
                                            "quark_hyperkzg", "quark_mock",
                                            "fib3_spans",
                                            "fib3_proof_bytes",
                                            "fib3_spans_chain", "fs_device",
                                            "mesh", "fs_degree"]
    chosen = list(argv if argv is not None else sys.argv[1:]) or names
    for name in chosen:
        if name not in names:
            raise SystemExit(f"unknown case {name}; cases: {names}")
        t0 = time.perf_counter()
        if name in ("fib3_proof_bytes", "quark_mock", "fib3_spans",
                    "fib3_spans_chain"):
            if name == "fib3_proof_bytes":
                record = fib3_proof_bytes()
            elif name == "quark_mock":
                from jolt_tpu_torch.subprotocols import fixtures as sfx
                record = {case: quark_mock_case(*args)
                          for case, args in sfx.QUARK_MOCK_CASES.items()}
            elif name == "fib3_spans_chain":
                with env(FS_DEVICE_ENV):
                    record = {"rows": fib3_proof("mock", spans=True)}
            else:
                record = {"rows": fib3_proof("mock", spans=True)}
            path = OUT_DIR / f"{name}.json"
            indent = None if name == "quark_mock" else 1
            path.write_text(json.dumps(record, indent=indent) + "\n")
            print(f"{path.relative_to(ROOT)}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            continue
        if name in PCS_CASES:
            arrays = prove_pcs_case(name)
        elif name == "jolt_parts":
            arrays = jolt_parts_arrays()
        elif name == "fs_device":
            arrays = fs_device_arrays()
        elif name == "mesh":
            arrays = mesh_arrays()
        elif name == "fs_degree":
            arrays = fs_degree_arrays()
        elif name == "quark_hyperkzg":
            arrays = prove_quark_case()
        elif name.startswith("fib3_"):
            arrays = prove_case(name[len("fib3_"):])
        else:
            arrays = prove_rv32i_case(name)
        path = OUT_DIR / f"{name}.npz"
        np.savez_compressed(path, **arrays)
        print(f"{path.relative_to(ROOT)}: "
              f"{len(next(iter(arrays.values())))} transcript states, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
