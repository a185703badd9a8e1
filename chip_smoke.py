#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (jolt_tpu_torch) on one GPU.

    python3 chip_smoke.py          # from the root of a checkout, on a CUDA card

Phases (any failure exits non-zero, no phase catches and carries on):
  1. the card's name and power limit (nvidia-smi); build every kernel
     (one nvcc per source, started together) and read each kernel
     function's registers, spills and shared memory from the ptxas
     report, with the warps per SM they leave room for;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the nv = 20 Surge prove gives it (K7: the SRS fixture tiled),
     compared for equality, and timed with CUDA events on the card alone
     (event_ms: the card sleeps while the host enqueues the timed calls)
     (kernel_ms, plain_ms, and the bound from bytes and from 32-bit
     multiplies; for K8 and K9 also the bound of the work's dependent
     chain, beside that of one thread running all of it);
     then K2 at the fib GP's batch (B = 43, 64; s = 2^15, 2^9, 2^5), at
     the full VM's (B = 65, 81, 110, 128, and 200, which the wrapper
     splits over two launches; s = 2^15, 2^5) with K3 at B = 110, and
     K2 and K5 on edge residues (0, 1, p - 1, R mod p, ... so that the
     lazy sums cross p and 2p), with K5's lanes holding P + P, P + (-P)
     and the identity; then the device Fiat-Shamir kernels: K8 (the
     transcript events) against its plain version and the host Transcript
     over 1,024 chained events (appends of edge scalars, challenges) and
     at the main path's shapes (a challenge vector of 110, 220 appends,
     a chained GKR layer's one list: 220 appends, 1 challenge, 110
     challenges),
     K9 (the sumcheck round) at d = 2 and 3 with the hint, at the full
     VM's primary degree 8 without it, and past it at d = 9 (the hint)
     and d = 12, on edge residues; then the field programs: K10 (the
     modular add and subtract) on the primary round's e_t halves,
     [16, 55, 2^15] views of [16, 55, 2^16], and on a broadcast scalar,
     edge residues and a = b, K11 (the modular sum) over 2^23 terms (the
     sha2-chain prove's largest sum) and 2^20, over the leading axis of
     [16, 110, 2^15] (a lane a row, 8 warps along the terms) and at
     lengths 1 and 3, and the primary round's kernel (the extrapolation,
     rv32i_vm()'s 29 collations through the group plan, the finisher and
     the sum of every point, one launch a round) at the first round (E
     [16, 55, 2^16], flags [16, 29, 2^16], eq and out [16, 2^16]; h =
     2^15), at h = 2^12,
     at h = 2 and 1 on edge residues, on the mini VM (ADD, BNE) and on
     one shard of a 2-shard mesh's first round (cyclic, h = 2^14), with
     its INT32, bytes and chain bounds (the work's dependent chain, and
     the group plan's); then the toggle and reduction rounds: K14 (the
     toggled grand product's round evaluations) at its first round on
     the sha2 path (flags [16, 55, 2^16] Montgomery 0/1, fingerprints
     [16, 110, 2^16]), its last (s = 2) and s = 2^12 on edge residues,
     K15 (the binds) on the toggle's three tensors with the challenge on
     the card and on the reduction's eight with it by value, K16 (the
     reduction round's evaluations) at its first round (4 pairs of 2^16),
     17 pairs (two launches) and n = 2 on edge residues, K17 (the RLC) at
     the first append's 85 columns read in place, HyperKZG's 16
     polynomials padded to 2^16, and 50 polynomials (two launches) on
     edge residues; and each of the field programs' and the rounds'
     wrappers' host time per call;
  3. the main path begins (launch counts set to 0): HyperKZG setup of the
     2^20-point SRS, generated on the card; its first 2^17 points must equal
     fixtures/srs/srs_131072_6a6f6c74.npz bit for bit;
  4. Surge XOR, nv = 20, C = 4, M = 2^16, operands from default_rng(0) as
     `python -m jolt_tpu_torch.cli surge-bench` draws them: one warm-up
     prove (the main path's launch counts are read after it), verify, a
     tampered proof must be rejected, one timed prove (two until phase 8
     proved twice) and a timed verify;
  5. reference on a small input: Surge at nv = 10 on the card and on the
     CPU (plain versions) must give the same transcript and commitments,
     and two commitments must equal a host MSM;
  6. the Jolt VM's main path (launch counts set to 0 before it): the
     fibonacci(3275) program on the mini VM (ADD, BNE; C = 4, M = 2^16)
     traced to 16,380 steps, padded to T = 2^14 (cut from 2^16 to keep the
     script's time; the full VM's phases 8 and 10 keep T = 2^16), HyperKZG
     setup from the 2^16-point SRS fixture, one timed prove (K1-K5 must
     have launched) during which the inputs of each kernel's largest call
     are kept and then replayed against the plain version as in phase 2,
     the verifier's accept, a proof with one opening bumped by one rejected,
     and a timed verify (each VM phase proves once: a second, timed prove
     went to keep the script's time; the peak memory printed includes the
     kept copies, and says how much of it they are);
  7. reference on a small input: fibonacci(3) on the mini VM at M = 2^8
     with HyperKZG over 2^8 points, on the card and on the CPU: both
     transcripts must equal jolt_tpu's, frozen in fixtures/port/
     (scripts/freeze_port_fixtures.py), read here with numpy;
  8. the full RV32I VM's main path (launch counts set to 0 before it):
     sha2-chain(13) on rv32i_vm() (29 instructions, 26 subtables, C = 4,
     M = 2^16) with the input 0x05 x 32, traced to 62,413 steps, padded to
     T = 2^16, HyperKZG from the SRS fixture, as phase 6: one timed prove
     (K1-K5, K10, K11, the round and K14-K17 must have launched; the
     largest call
     of each kernel,
     and of K2 and K3 at each batch size, replayed against the plain
     version),
     accept, tamper rejected, timed verify; the guest's 32
     output bytes must equal hashlib's sha256 iterated 13 times.  The
     prove runs with device Fiat-Shamir and the chained grand products
     (the default on the card; K8 and K9 must launch), and then once more
     with JOLT_TPU_DEVICE_FS=0 (every round's transcript on the host): its
     state_history must equal the first prove's event for event, and both
     proves' seconds are printed, with K8's and K9's launches in the
     first prove and their summed device ms (each shape's calls times its
     kernel's time on the card alone at that shape), and the first
     prove's launches of K1, K10, K11, the round and K14-K17 and of all
     kernels (beside the 11,690 of the prove before the toggle and
     reduction rounds were kernels), and
     each kernel's calls in it with the sum of their bounds (the larger
     of bytes, operations and, for K8, K9 and the round, the work's
     dependent chain, per call) and that sum with one launch (phase 2's
     launch floor) a call; every K11 call of that prove is kept with its
     strides (strided_copy) and replayed against field_sum_plain (max
     abs err 0), its calls and bound sums printed by (rows, n).  The
     first prove runs with the profiling spans on (utils/profiling.py; each
     syncs the card on entry and exit): their table is printed, and each
     of the seven top-level prove spans (witness_generation,
     JoltPolynomials::commit, BytecodeProof::prove_memory_checking,
     InstructionLookupsProof::prove, ReadWriteMemoryProof::prove,
     UniformSpartanProof::prove, reduce_and_prove) must fire once, their
     sum lying within 90-100 % of the prove's seconds, and the chained
     grand products' spans BatchedDenseGP::chained and ToggledGP::chained
     must be among them;
  9. reference at full width: rv32i_vm() (M = 2^16) with the mock PCS on
     the card proves each frozen case of jolt_tpu_torch/vm/fixtures.py
     (fibonacci(8), the M-extension program, a program of every load and
     store width, sha2_chain_program(1), multi_function_program(4) with
     its JAL calls and JALR returns): its transcript and its
     commitments' digests must equal jolt_tpu's (fixtures/port/<case>.npz);
     then the load/store program with HyperKZG over the 2^16-point SRS
     fixture, whose transcript, commitment digests and arkworks proof
     bytes' SHA-256 must equal jolt_tpu's;
 10. the user's path (launch counts set to 0 before it): sha3_chain_program
     (2) written to an ELF file by tracer/elf_write.py, its bytes given to
     sdk.build_provable (HyperKZG, on the card), whose prove decodes them,
     traces them with the native tracer to 44,479 steps (T = 2^16), sets
     up and proves, timed (K1-K5 must launch, and their largest calls are
     replayed as in phase 8); the output must equal hashlib's sha3_256
     iterated twice; the proof's arkworks bytes (proof_size_bytes) are
     re-read by the structure reader; its canonical bytes are read back,
     and the proof read back verifies, and is rejected with one opening
     bumped by one; then a timed verify through the SDK;
 11. the commitment schemes at 2^20 (launch counts set to 0 before it):
     the pcs-bench polynomial (2^20 values below 2^63 from default_rng(0))
     committed cold and warm, opened at a point from random.Random(11),
     verified, and a tampered opening refused, by HyperKZG (phase 3's
     SRS), Zeromorph (2^20 + 1 SRS points generated on the card from seed
     0x5A4D, the first 2^10 checked against host g * tau^i) and Hyrax
     (1,024 generators checked against host g * k; its commits launch K6
     and K7); the largest call of each kernel, for HyperKZG and Zeromorph
     together and for Hyrax, is recorded and replayed against its plain
     version; a BatchedHyraxOpeningProof of four 2^16 polynomials
     verified and refused with an opening bumped; K1, K5, K6 and K7 must
     have launched; then the reference: each scheme's 2^10 commitment on
     the card and the CPU equal, HyperKZG's and Hyrax's row 0 equal to a
     host MSM, and jolt_tpu's frozen Zeromorph and Hyrax openings
     (fixtures/port/zeromorph_l6.npz, hyrax_l7.npz: transcripts,
     commitments, proofs) reproduced on the card;
 12. Quarks and the grand-product commit (launch counts set to 0 before
     each part): B = 16 circuits of 2^20 leaves in [1, 2^63) from
     default_rng(12) (one batch of memory-checking fingerprints of a
     2^20-step trace, 1 GiB of leaves) through QuarkGrandProduct: four
     dense GKR base layers and a quark top over 2^16 (16 sumcheck rounds,
     35 polynomials), HyperKZG over the 2^16-point SRS fixture, the 16 g
     commitments through BatchType.GRAND_PRODUCT (g_products: 16 K6
     levels); one timed prove with the opening reduction (K1, K2, K3, K5
     and K6 must launch; the largest call of each replayed), the claims
     against BatchedDenseGrandProduct's, verify, a helper value bumped by
     one refused, the canonical bytes read back; then the reference
     bench's shape (benches/commit.rs): 2^20 coefficients, 90 % one, the
     rest uniform from default_rng(13), with phase 3's SRS: g_products'
     first build (20 K6 levels from 2^19 lanes) timed apart, warm commits
     through GRAND_PRODUCT and BIG, which must be the same point (K1, K5,
     K6 must launch; their largest calls replayed);
 13. the EVM verifier path (launch counts set to 0 before it): the four
     fixture generators of evm/fixtures.py on the card (K1-K5 must
     launch) must equal fixtures/evm/*.json field for field; the
     generated R1CSMatrix.sol must equal
     evm_verifier/src/subprotocols/R1CSMatrix.sol byte for byte; the
     port's Solidity-subset VM executes GrandProductVerifier.verify,
     HyperKZG.verify and SpartanVerifier.verifySpartan on the generated
     fixtures, accepts them, and reverts on one tampered value each;
 14. the scaffold: `cli.py new` writes a guest and host project into a
     temporary directory, and its host.py runs as __main__ in a child
     process on the card (HyperKZG): it must print `proof verified`, and
     K1-K5 must have launched in that process;
 15. the traced prove: `python -m jolt_tpu_torch.cli --trace DIR prove-fib
     --n 8 --pcs hyperkzg --profile` in a child process on the card must
     exit 0; its DIR/trace.json (torch.profiler, CPU and CUDA) must parse
     as JSON and hold the span names (the seven top-level prove spans,
     BatchedDenseGP::chained, ToggledGP::chained,
     Sumcheck::prove_arbitrary) and at least one
     mont_mul_kernel (K1) kernel event; the child's span table is
     printed;
 16. the multi-device prover (parallel/sharding.py; launch counts set to
     0 before it): with more than one card a real mesh over every card,
     else a virtual mesh on cuda:0 (every shard on the one card, each step
     run once per shard): (a) one GKR round at B = 110 circuits (padded
     to the mesh, 4 shards on one card), s = 2^15 per side, whose
     evaluations and bound layers must equal one unsharded K2 and K3
     call, with K2 and K3 launched once per shard; (b) the HyperKZG batch
     commit of phase 11's 2^20 polynomial with phase 3's SRS split over
     the mesh (K5 per shard, K6 across shards) must equal the unsharded
     commitment, and sharded_msm (the window MSM: K6, K7) over 2^10
     points the host MSM; (c) sha2-chain(13) on rv32i_vm() at T = 2^16
     with HyperKZG through JoltVM.prove(mesh=) (2 shards on one card),
     device Fiat-Shamir on (K9; the grand products are not chained on
     a mesh, as in jolt_tpu, so K8 does not launch): K1-K6 and K9 must
     launch, its state_history must equal phase 8's first prove's, its
     output hashlib's; it verifies, a bumped opening is rejected; its
     seconds and launches are printed.
Phase 1 also builds the native tracer and Keccak (g++) from their sources
and prints the compiler and the libraries' paths.  Then a {"kernels":
[...]} JSON line, the card line again, and last {"ok": true, "device":
{...}}.  Imports nothing of JAX or jolt_tpu.
K7 (jac_double) lies on no VM or Surge path (see csrc/point.cu): phase 2
holds it against its plain version, and those paths' launch checks exempt
it; phase 11's Hyrax commit launches it.  The primary round's kernel
(primary_round) lies on the VM paths, not on Surge's (phase 4 exempts
it); the kernels line's `launches` of K10, K11, the round and K14-K17 are
phase 8's sha2-chain(13) path (setup and the prove); K14-K17 lie on the
VM paths, not on Surge's (phase 4 exempts them).  Phases 3-10, 12 (the quark
path) and 13-15 run with device Fiat-Shamir, the default on the card, so
K8 and K9 launch on them.
"""
from __future__ import annotations

import json
import math
import os
import random
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory (data sheet)
HOLD_CYCLES = 20_000_000           # event_ms's sleep before the timed
#   calls: some 10 ms at 1,980 MHz, longer than the host takes to enqueue
#   ten calls of any wrapper
SMS = 132                          # H100 SXM streaming multiprocessors
IMAD_PER_CLK_SM = 64               # 32-bit integer multiply(-add) results
#   per clock per SM at compute capability 9.0 (CUDA C++ Programming
#   Guide, "Arithmetic Instructions" throughput table)
MULS_PER_PRODUCT = 264             # 32-bit multiplies one 256-bit Montgomery
#   product needs (CIOS over eight 32-bit words, csrc/field.cuh): 64 word
#   products a_i*b_j and 64 m_i*p_j, each a low and a high half, and 8 low
#   halves m_i = t_0 * inv
NV = 20
FIB_N, FIB_STEPS, FIB_T, FIB_M = 3275, 16380, 1 << 14, 1 << 16
SHA2_ITERS, SHA2_STEPS, SHA2_T = 13, 62413, 1 << 16
SHA3_ITERS, SHA3_STEPS, SHA3_T = 2, 44479, 1 << 16
GP_KERNELS = ("gp_pair_evals", "gp_pair_bind")
FS_KERNELS = ("transcript_events", "fs_round")   # K8, K9: device Fiat-Shamir
KECCAK_OPS = 24 * 210              # 32-bit operations of one Keccak-f[1600]
#   on lo/hi halves, each lane once: per round theta 110 (xor5 of 5 columns, 5
#   rotl-1, 25 xors), rho 48 (24 rotations, two funnel shifts each), chi 50
#   (one LOP3 per 32-bit half), iota 2
KECCAK_DEPTH = 24 * 7              # dependent instruction levels of one
#   permutation: per round 2 (xor5 as two LOP3), 2 (rotl-1, xor), 1 (a ^=
#   d), 1 (rho), 1 (chi and iota as LOP3s)
PRODUCT_DEPTH = 8 * 2 * 9          # dependent levels of one Montgomery
#   product (csrc/field.cuh): per word b_i a row and a reduction, each a
#   carry chain of 9 multiply-adds
ADD_DEPTH = 2 * 9                  # dependent levels of one modular add
#   (field.cuh add_mod): the carry chain and the conditional subtraction's
#   borrow chain
DEP_CYCLES = 4                     # latency of a dependent integer
#   instruction on the H100's SMs (fixed-latency ALU ops)
REGS_PER_SM, SMEM_PER_SM, MAX_WARPS_PER_SM = 65536, 228 * 1024, 64
OFF_PATH = {"jac_double": "no VM or Surge prove path of either package "
            "launches jac_double_pallas (K7); phase 11's Hyrax commit does "
            "(the windowed MSM's Horner doublings)"}
SUMCHECK_KERNELS = ("toggle_evals", "bind_halves", "reduction_evals",
                    "rlc")         # K14-K17 (csrc/sumcheck_ops.cu)
OFF_SURGE = {"primary_round": "the Jolt VM's primary sumcheck round (its "
             "collations and finisher); Surge's primary sumcheck runs "
             "`combine_with_eq` through `Sumcheck::prove_arbitrary`",
             **{k: "the Jolt VM's toggled grand product and opening "
                "reduction; Surge's prove has neither (its opening "
                "accumulator stays unused, as the reference's)"
                for k in SUMCHECK_KERNELS}}
FIELD_KERNELS = ("field_addsub", "field_sum",
                 "primary_round") + SUMCHECK_KERNELS   # their kernels
#   line's launches are phase 8's path
LAUNCHES_BEFORE = 11690            # all launches of a sha2-chain(13) prove
#   before the toggle and reduction rounds were kernels (PERF.md)
CHAIN_KERNELS = FS_KERNELS + ("primary_round",)   # bounded by a chain
ADDSUB_OPS = 25                    # 32-bit operations of one modular add
#   or subtract (field.cuh add_mod, sub_mod): 8-word add (subtract), the
#   8-word conditional subtraction (addition) with its borrow, 8 selects
PCS_LOGN = 20
VM_KERNELS = ("mont_mul", "mont_mul_bl", "gp_pair_evals", "gp_pair_bind",
              "proj_cadd") + FS_KERNELS + FIELD_KERNELS
PCS_KERNELS = ("mont_mul", "proj_cadd", "jac_add", "jac_double")
HYRAX_KERNELS = ("mont_mul", "jac_add", "jac_double")
KZG_KERNELS = ("mont_mul", "proj_cadd")
QUARK_B, QUARK_LOGN, QUARK_SRS = 16, 20, 1 << 16
QUARK_KERNELS = ("mont_mul", "gp_pair_evals", "gp_pair_bind", "fs_round",
                 "proj_cadd",
                 "jac_add", "bind_halves", "reduction_evals", "rlc")
GP_COMMIT_LOGN = 20
GP_COMMIT_KERNELS = ("mont_mul", "proj_cadd", "jac_add")
# phase 16 (c): the mesh prove's kernels.  On a mesh the grand products
# are not chained (jolt_tpu's _chain_ok), so K8 does not launch; K6
# folds the sharded commit's per-shard sums
MESH_KERNELS = ("mont_mul", "mont_mul_bl", "gp_pair_evals", "gp_pair_bind",
                "proj_cadd", "jac_add", "fs_round") + FIELD_KERNELS
EVM_KERNELS = ("mont_mul", "mont_mul_bl", "gp_pair_evals", "gp_pair_bind",
               "proj_cadd")
# phase 14 runs the scaffold's host.py as __main__ in a child process and
# prints that process's launch counts after it
SCAFFOLD_RUNNER = (
    "import json, runpy, sys; sys.path.insert(0, '.'); "
    "from jolt_tpu_torch import _native as nat; "
    "runpy.run_path('host.py', run_name='__main__'); "
    "print('launches ' + json.dumps(nat.launch_counts()), flush=True)")
# the prove's top-level spans (jolt_tpu/vm/jolt.py's names), which phase 8
# checks cover the prove
PROVE_SPANS = ("witness_generation", "JoltPolynomials::commit",
               "BytecodeProof::prove_memory_checking",
               "InstructionLookupsProof::prove", "ReadWriteMemoryProof::prove",
               "UniformSpartanProof::prove", "reduce_and_prove")
SPAN_COVER = (0.90, 1.00)
# phase 15: the CLI's traced prove, in a child process on the card
TRACE_CMD = ("prove-fib", "--n", "8", "--pcs", "hyperkzg", "--profile")
TRACE_SPANS = PROVE_SPANS + ("BatchedDenseGP::chained", "ToggledGP::chained",
                             "Sumcheck::prove_arbitrary")
CHAIN_SPANS = ("BatchedDenseGP::chained", "ToggledGP::chained")


def fs_work(name: str, args) -> tuple[int, int, int]:
    """(bytes, Montgomery products, Keccak permutations) of one K8 or K9
    call: K8 appends n scalars (a product each, to the canonical form) and
    draws c challenges (a product each, to Montgomery form), n + c
    permutations; K9 at degree d interpolates ((d + 1)^2 products), appends
    d coefficients and two labels, draws one challenge and runs Horner (d
    products): 3 + d permutations."""
    if name == "transcript_events":
        from jolt_tpu_torch.utils import keccak_device as kd
        _, _, scalars, segments = args
        n, c = kd._check_segments(segments, 0 if scalars is None
                                  else scalars.shape[1])
        return 2 * 9 * 8 + 64 * (n + c), n + c, n + c
    _, evals, _, _, d, _ = args
    return (2 * 9 * 8 + 64 * (evals.shape[1] + 1 + (d + 1) ** 2 + d + 2),
            (d + 1) ** 2 + d + 1 + d, 3 + d)


def fs_chain_levels(name: str, args) -> tuple[int, int]:
    """Dependent instruction levels of one K8 or K9 call: (the work's
    chain, the chain of a design that runs all of it in one thread).  The
    work's chain: for K8, the permutations in order, then the last
    challenge's Montgomery form (the appends' canonical forms and the
    other challenges' forms lie beside it); for K9 at degree d, the longer
    of the UniPoly_begin permutation and the first coefficient's
    interpolation (its products side by side, their sum as a tree) and
    canonical form, then d + 2 permutations, then the challenge's
    Montgomery form and Horner (d products and d adds).  The one-thread
    chain puts every product (fs_work) after the permutations."""
    _, prods, perms = fs_work(name, args)
    serial = perms * KECCAK_DEPTH + prods * PRODUCT_DEPTH
    if name == "transcript_events":
        from jolt_tpu_torch.utils import keccak_device as kd
        _, _, scalars, segments = args
        _, c = kd._check_segments(segments, 0 if scalars is None
                                  else scalars.shape[1])
        return perms * KECCAK_DEPTH + (PRODUCT_DEPTH if c else 0), serial
    d = args[4]
    interp = (2 * PRODUCT_DEPTH
              + math.ceil(math.log2(d + 1)) * ADD_DEPTH)
    return (max(KECCAK_DEPTH, interp) + (d + 2) * KECCAK_DEPTH
            + (d + 1) * PRODUCT_DEPTH + d * ADD_DEPTH), serial


def round_chain_levels(args) -> tuple[int, int]:
    """Dependent instruction levels of one call of the primary round's
    kernel: (the work's chain, the group plan's).  The work's: a staged
    column's extrapolation to the last point (the subtract, t's doublings,
    the add of lo), then the deepest instruction's collation as a DAG and
    its f_k product, the instructions' terms summed as a tree, the
    finisher (a subtract and a product), the sum over the h elements as a
    tree.  The plan's, as the kernel runs it: the stage (the subtract, the
    doublings and adds of the block's first point and of its step, the
    add of lo), then for each of a block's points its longest group's
    rows in order, the G partial sums in turn, the finisher, the warp's
    shuffle tree and the step to the next point; then the last block's
    sum of a point's tile partials (ceil(tiles / 32) a lane, then the
    shuffle tree)."""
    from jolt_tpu_torch.vm import collation
    from jolt_tpu_torch.vm.instruction_lookups import round_plan
    pre, eq = args[0], args[1]
    prog = collation.program(pre)
    plan = prog.plan
    n = eq.shape[-1]
    points, split, tiles, _ = round_plan(pre, n)
    lg = lambda x: math.ceil(math.log2(x)) if x > 1 else 0  # noqa: E731
    mask = (1 << collation.KIND_SHIFT) - 1
    depth, terms = {}, []            # a slot's levels; each term's
    for op, dst, a, b in prog.rows:
        d = max(depth[r & mask] if r >> collation.KIND_SHIFT ==
                collation.SLOT else 0 for r in (a, b))
        depth[dst] = d + (PRODUCT_DEPTH if op == collation.MUL
                          else ADD_DEPTH)
        if op == collation.MUL and collation.F_COL in (
                a >> collation.KIND_SHIFT, b >> collation.KIND_SHIFT):
            terms.append(depth[dst])
    extrap = ADD_DEPTH * (2 + lg(points - 1)) if points > 2 else ADD_DEPTH
    chain = (extrap + max(terms) + ADD_DEPTH * lg(len(terms))
             + ADD_DEPTH + PRODUCT_DEPTH + ADD_DEPTH * lg(n // 2))
    stage = ADD_DEPTH * (2 + 2 * split.bit_length()
                         + 2 * (split - 1).bit_length())
    per_point = (max(plan.levels) + ADD_DEPTH * plan.n_groups + ADD_DEPTH
                 + PRODUCT_DEPTH + 5 * ADD_DEPTH + ADD_DEPTH)
    final = ADD_DEPTH * (-(-tiles // 32) + 5)
    return chain, stage + -(-points // split) * per_point + final


def work(name: str, args) -> tuple[int, int]:
    """(bytes, Montgomery products) that one call of kernel `name` needs:
    each input read once and each output written once (int32 limbs; the
    primary round reads the lo and hi halves of the columns its group
    plan stages), and the products of the function itself (the round: its
    program's and the finisher's, per element and point): K2 5B + 3 per
    pair of B circuits,
    K3 2B + 1, K5 12 per add (RCB16 Alg. 7), K6 16 (an add; the doubling
    and infinity lanes of phase 2 are 2^-14 of its lanes), K7 7
    (dbl-2009-l); K8 and K9 as fs_work (their Keccak operations are added
    to the operations by `compare`)."""
    if name in FS_KERNELS:
        return fs_work(name, args)[:2]
    tb = lambda *ts: 4 * sum(t.numel() for t in ts)
    if name == "field_addsub":
        import torch
        _, a, b, op = args
        n = math.prod(torch.broadcast_shapes(a.shape, b.shape)[1:])
        return tb(b) + (0 if op == 2 else tb(a)) + 4 * 16 * n, 0
    if name == "field_sum":
        _, a, axis = args
        ax = axis + 1 if axis >= 0 else axis + a.dim()
        return tb(a) + 4 * a.numel() // a.shape[ax], 0
    if name == "primary_round":
        from jolt_tpu_torch.vm import collation
        pre, eq = args[0], args[1]
        prog, n = collation.program(pre), eq.shape[-1]
        points = pre.sumcheck_degree + 1
        return (4 * 16 * (n * len(prog.plan.stage) + points),
                points * n // 2 * (prog.products + 1))
    if name == "toggle_evals":          # the kernel's formula: 7 products
        _, flags, fps, eq, coeffs = args    # a memory, 3 a pair index
        m, h = flags.shape[1], flags.shape[-1] // 2
        return tb(flags, fps, eq, coeffs) + 4 * 16 * 3, h * (7 * m + 3)
    if name == "bind_halves":
        ts = args[1]
        n = sum(t.numel() // 16 for t in ts) // 2
        return tb(*ts) + 4 * 16 * n + 4 * 16, n
    if name == "reduction_evals":
        _, polys, eqs = args[:3]
        A, h = len(polys), polys[0].shape[-1] // 2
        return tb(*polys, *eqs) + 4 * 16 * 2, 2 * A * h + 2 * A
    if name == "rlc":
        _, polys, _, n = args
        return tb(*polys) + 4 * 16 * n, sum(p.shape[-1] for p in polys)
    if name == "mont_mul":
        import torch
        _, a, b = args
        n = math.prod(torch.broadcast_shapes(a.shape, b.shape)[1:])
        return tb(a, b) + 4 * 16 * n, n
    if name == "mont_mul_bl":
        _, a, b = args
        return 3 * tb(a), a.shape[0] * a.shape[2]
    if name in ("gp_pair_evals", "gp_pair_bind"):
        _, l, r, eq, x = args
        B, h = l.shape[0], l.shape[2] // 2
        if name == "gp_pair_evals":
            return tb(l, r, eq, x) + 4 * 16 * 3, (5 * B + 3) * h
        return tb(l, r, eq) * 3 // 2 + 4 * 16, (2 * B + 1) * h
    pts = [t for p in args for t in p]
    n = pts[0][0].numel()
    per = {"proj_cadd": 12, "jac_add": 16, "jac_double": 7}[name]
    return tb(*pts) + 3 * 4 * 16 * n, per * n


def sum_shape(a, axis: int) -> tuple[int, int]:
    """(rows, n) of a K11 call on limb tensor `a` [16, ...]: rows sums of
    n terms along logical axis `axis`."""
    n = a.shape[axis + 1 if axis >= 0 else axis + a.dim()]
    return a.numel() // 16 // n, n


def field_adds(name: str, args) -> int:
    """Modular adds and subtracts of one K10, K11 or primary round call
    (ADDSUB_OPS 32-bit operations each): an add an element; n - 1 a sum
    of n terms; for the round, per staged column and element the subtract
    hi - lo and an add a point past t = 1, per element and point the
    program's adds and subtracts and the finisher's subtract, per point
    the sum of the h terms."""
    if name == "field_addsub":
        import torch
        return math.prod(torch.broadcast_shapes(args[1].shape,
                                                args[2].shape)[1:])
    if name == "field_sum":
        rows, n = sum_shape(*args[1:])
        return rows * (n - 1)
    if name == "primary_round":
        from jolt_tpu_torch.vm import collation
        pre, h = args[0], args[1].shape[-1] // 2
        prog, points = collation.program(pre), pre.sumcheck_degree + 1
        return (points * h * (prog.adds + 1) + points * (h - 1)
                + len(prog.plan.stage) * h * (points - 1))
    if name == "toggle_evals":      # csrc/sumcheck_ops.cu's formula: 22
        m, h = args[1].shape[1], args[1].shape[-1] // 2   # a memory, 12
        return h * (22 * m + 12)                          # a pair index
    if name == "bind_halves":       # a subtract and an add an output
        return sum(t.numel() // 16 for t in args[1])
    if name == "reduction_evals":   # 6 a pair index of a pair
        A, h = len(args[1]), args[1][0].shape[-1] // 2
        return 6 * A * h + 2 * A + 2
    if name == "rlc":               # an add an input element
        return sum(p.shape[-1] for p in args[1])
    return 0


def call_bounds(name: str, args, imad_rate: float) -> tuple:
    """(bytes, 32-bit operations, bytes bound ms, operations bound ms)
    of one call of kernel `name`: work's bytes and products, the Keccak's
    and the modular adds' operations besides, at HBM_BYTES_PER_S and
    `imad_rate` 32-bit operations a second."""
    nbytes, products = work(name, args)
    ops = products * MULS_PER_PRODUCT
    if name in FS_KERNELS:              # and the Keccak's 32-bit operations
        ops += fs_work(name, args)[2] * KECCAK_OPS
    ops += field_adds(name, args) * ADDSUB_OPS
    return (nbytes, ops, nbytes / HBM_BYTES_PER_S * 1e3,
            ops / imad_rate * 1e3)


def launch_floor_ms() -> float:
    """One launch: a one-element kernel, launched back to back."""
    import torch
    tiny = torch.zeros(1, dtype=torch.int64, device="cuda")
    return event_ms(lambda: tiny.add_(1), 100)


def ptxas_usage(reports: dict[str, str]) -> dict[str, dict]:
    """{CUDA function: registers, spill bytes, static shared bytes} from
    the -Xptxas -v reports of the libraries built in this run."""
    usage, fn = {}, None
    for text in reports.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
                usage[fn] = {"registers": None, "spill_bytes": None,
                             "smem_bytes": 0}
            elif fn and (m := re.search(r"(\d+) bytes spill stores, "
                                        r"(\d+) bytes spill loads", line)):
                usage[fn]["spill_bytes"] = int(m[1]) + int(m[2])
            elif fn and (m := re.search(r"Used (\d+) registers", line)):
                usage[fn]["registers"] = int(m[1])
                sm = re.search(r"(\d+) bytes smem", line)
                usage[fn]["smem_bytes"] = int(sm[1]) if sm else 0
    return usage


def resident_warps(regs: int, smem: int, threads: int) -> int:
    """Warps per SM that the registers and shared memory of a block of
    `threads` leave room for (registers allocated per warp in units of
    256; 1 KB of shared memory reserved per block)."""
    wpb = -(-threads // 32)                    # a one-thread block: a warp
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min(REGS_PER_SM // per_warp // wpb,
                 SMEM_PER_SM // (smem + 1024), MAX_WARPS_PER_SM // wpb, 32)
    return blocks * wpb


def event_ms(fn, reps: int, warm: bool = False, hold: bool = True) -> float:
    """Device ms per call of `fn`, by CUDA events around `reps` calls.
    With `hold`, the card first sleeps (torch.cuda._sleep, HOLD_CYCLES)
    while the host enqueues the timed calls, so that a call whose host
    side may outlast its kernel (K8, K9: Python and ctypes around a
    kernel of microseconds) is timed by its kernels back to back, not by
    the host.  Without it, one call is left running when the start event
    is recorded (the earlier method, which times the host where it is the
    slower).  A first call warms up, unless `warm` says that fn has just
    run."""
    import torch
    if not warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    else:
        fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def strided_copy(t):
    """A copy of tensor `t` with its strides and its offset mod 16 bytes:
    the span of storage that t reads, copied into a new buffer (so that a
    replayed K11 call takes the layout and the plan of the first)."""
    import torch
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
    pad = t.storage_offset() % 4
    flat = torch.as_strided(t, (span,), (1,), t.storage_offset())
    buf = torch.empty(span + pad, dtype=t.dtype, device=t.device)
    buf[pad:].copy_(flat)
    return torch.as_strided(buf, t.shape, t.stride(), pad)


_HOST_POOL = None                  # phase 11's host checks (see main)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    if _HOST_POOL is not None:
        _HOST_POOL.shutdown(cancel_futures=True)
    sys.exit(1)


def host_g_times(ks: list[int]) -> list:
    """g * k on the host, by double-and-add, for each k (a worker process
    of phase 11's checks of the card's fixed-base points)."""
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch.curve.bn254 import G1Affine
    g = G1Affine.generator().to_jacobian()
    return [g.mul(k).to_affine() for k in ks]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def sass_counts(lib_path) -> dict[str, dict[str, int]]:
    """Static SASS instructions per kernel function of a built library
    (cuobjdump): the integer multiply-adds (IMAD family, moves excluded),
    the integer adds (IADD3 family), selects, and all instructions."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    out = subprocess.run([str(tool if tool.exists() else "cuobjdump"),
                          "-sass", str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = dict(imad=0, iadd3=0, sel=0, total=0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if fn and m:
            op = m[1]
            c = counts[fn]
            c["total"] += 1
            if op.startswith("IMAD") and not op.startswith("IMAD.MOV"):
                c["imad"] += 1
            elif op.startswith("IADD3"):
                c["iadd3"] += 1
            elif op == "SEL":
                c["sel"] += 1
    return counts


def main() -> None:
    if not (ROOT / "jolt_tpu_torch" / "csrc").is_dir() \
            or not (ROOT / "fixtures" / "srs").is_dir() \
            or not (ROOT / "fixtures" / "port").is_dir():
        fail("run from the root of a checkout: jolt_tpu_torch/ and "
             "fixtures/ are missing")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from jolt_tpu_torch import _native as nat
    from jolt_tpu_torch import cli, native, sdk
    from jolt_tpu_torch.curve import device as cd
    from jolt_tpu_torch.curve import kernels as ck
    from jolt_tpu_torch.curve.bn254 import G1Jacobian
    from jolt_tpu_torch.curve.device import FOLD_LANES, MSM_CHANNEL_CHUNK
    from jolt_tpu_torch.field import arith
    from jolt_tpu_torch.field import device as fd
    from jolt_tpu_torch.field import kernels as fk
    from jolt_tpu_torch.field.host import FElt
    from jolt_tpu_torch.field.spec import FieldSpec, fq_spec, fr_spec
    from jolt_tpu_torch.instructions import (RV32I_INSTRUCTIONS,
                                             XorInstruction)
    from jolt_tpu_torch.parallel import sharding as sh
    from jolt_tpu_torch.lasso import (SurgePreprocessing, generate_witness,
                                      surge_prove, surge_verify)
    from jolt_tpu_torch.commitment import fixtures as pfx
    from jolt_tpu_torch.commitment.base import BatchType
    from jolt_tpu_torch.commitment.hyperkzg import HyperKZG
    from jolt_tpu_torch.commitment.hyrax import (GENERATORS_LABEL,
                                                 HyraxOpeningProof,
                                                 HyraxScheme,
                                                 matrix_dimensions)
    from jolt_tpu_torch.commitment.mock import MockCommitmentScheme
    from jolt_tpu_torch.commitment.zeromorph import ZEROMORPH_SEED, Zeromorph
    from jolt_tpu_torch.evm import fixtures as evm_fixtures
    from jolt_tpu_torch.evm.gen_r1cs_sol import generate as gen_r1cs_sol
    from jolt_tpu_torch.evm.solidity_vm import SolidityRevert, load_vm
    from jolt_tpu_torch.poly.opening_proof import (
        ProverOpeningAccumulator, VerifierOpeningAccumulator)
    from jolt_tpu_torch.subprotocols.grand_product import \
        BatchedDenseGrandProduct
    from jolt_tpu_torch.subprotocols import fs_device as fsd
    from jolt_tpu_torch.subprotocols.grand_product_quarks import \
        QuarkGrandProduct
    from jolt_tpu_torch.utils import keccak_device as kd
    from jolt_tpu_torch.utils import profiling
    from jolt_tpu_torch.utils import serialization as ser
    from jolt_tpu_torch.curve.bn254 import G1Affine, g1_msm_host
    from jolt_tpu_torch.poly import mle
    from jolt_tpu_torch.transcript import Transcript
    from jolt_tpu_torch.subprotocols.sumcheck import VerificationError
    from jolt_tpu_torch.tracer.elf_write import write_elf
    from jolt_tpu_torch.utils.ark_proof import (
        deserialize_jolt_proof_structure, jolt_proof_bytes,
        serialize_surge_proof)
    from jolt_tpu_torch.vm.guests import (sha2_chain_expected,
                                          sha2_chain_program,
                                          sha3_chain_expected,
                                          sha3_chain_program)
    from jolt_tpu_torch.vm import fixtures as fx
    from jolt_tpu_torch.vm.host import fibonacci_program, trace_program
    from jolt_tpu_torch.vm import collation
    from jolt_tpu_torch.vm import instruction_lookups as il
    from jolt_tpu_torch.vm.rv32i_vm import RV32I_SUBTABLES, rv32i_vm

    dev = torch.device("cuda")
    FR, FQ = fr_spec(), fq_spec()
    card = card_line()
    print(card, flush=True)
    walls = {}                  # wall seconds of each phase
    clock = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        walls[name] = round(now - clock[0], 1)
        clock[0] = now

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    for name in nat.SOURCES:            # build from the sources, always
        nat.lib_path(name).unlink(missing_ok=True)
    reports = nat.build(ptxas_verbose=True)
    print(f"phase 1: built {len(nat.SOURCES)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    reported, usage = ptxas_usage(reports), {}
    for k in nat.KERNELS:
        fns = [f for f in reported if k.mangled in f]
        if not fns:
            fail(f"ptxas reported no function for {k.name} ({k.function})")
        u = dict(reported[fns[0]], threads=k.threads)
        u["resident_warps_per_sm"] = resident_warps(
            u["registers"], u["smem_bytes"], k.threads)
        usage[k.name] = u
        print(f"phase 1: {k.name}: {fns[0]}: {json.dumps(u)}", flush=True)
    for name in nat.SOURCES:
        for fn, c in sass_counts(nat.lib_path(name)).items():
            for k in nat.KERNELS:
                if k.mangled in fn:
                    usage[k.name]["sass"] = c
            print(f"phase 1: {name}.cu: {fn}: SASS {json.dumps(c)}",
                  flush=True)
    clock_hz = max_sm_clock_hz()
    imad_rate = SMS * IMAD_PER_CLK_SM * clock_hz
    t0 = time.perf_counter()
    native_libs = (("tracer.cpp", "libjolt_tracer", native.tracer_library),
                   ("keccak.cpp", "libjolt_keccak", native.keccak_library))
    for src, stem, load in native_libs:      # from the sources, always
        native.lib_path(src, stem).unlink(missing_ok=True)
        load.cache_clear()
        load()
    print(f"phase 1: native tracer and Keccak built by "
          f"{native.compiler_version()} in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(native.lib_path(src, stem).relative_to(ROOT))
                      for src, stem, _ in native_libs), flush=True)
    print(f"phase 1: max SM clock {clock_hz / 1e6:.0f} MHz; INT32 multiply "
          f"rate {imad_rate:.4g}/s; {MULS_PER_PRODUCT} 32-bit multiplies per "
          f"Montgomery product", flush=True)

    # phase 11's host recomputations of the card's fixed-base points (the
    # Zeromorph SRS's first 2^10 points g * tau^i and Hyrax's generators
    # g * k), 2,048 host scalar multiplications, run in worker processes
    # beside phases 2-10
    global _HOST_POOL
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    _HOST_POOL = ProcessPoolExecutor(
        4, mp_context=multiprocessing.get_context("spawn"))
    tau11 = random.Random(ZEROMORPH_SEED).randrange(1, FR.p)
    rng_g = random.Random(GENERATORS_LABEL)
    n_gens = matrix_dimensions(PCS_LOGN, 1)[1]
    host_checks = {
        name: [_HOST_POOL.submit(host_g_times, ks[lo:lo + 128])
               for lo in range(0, len(ks), 128)]
        for name, ks in (
            ("srs", [pow(tau11, i, FR.p) for i in range(1 << 10)]),
            ("gens", [rng_g.randrange(1, FR.p) for _ in range(n_gens)]))}
    phase_done("phase 1")

    # -- phase 2: each kernel against its plain version ------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand_fe(spec, *shape):
        """Reduced random field elements [16, *shape] (top limb below p's)."""
        t = torch.randint(0, 1 << 16, (16,) + shape, generator=gen,
                          device=dev, dtype=torch.int32)
        t[15] = torch.randint(0, int(spec.p_limbs[15]), shape, generator=gen,
                              device=dev, dtype=torch.int32)
        return t

    def edge_fe(spec, *shape):
        """Reduced elements [16, *shape], three in four drawn from edges
        (0, 1, 2, p - 1, p - 2, (p -+ 1)/2, R mod p, p - R mod p, 2^255 mod
        p), so that the kernels' lazy sums and differences cross p and
        2p."""
        p = spec.p
        pool = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, spec.r,
                p - spec.r, (1 << 255) % p]
        pool_t = torch.from_numpy(fd.pack_ints(pool).astype(np.int32)).to(dev)
        t = rand_fe(spec, *shape).reshape(16, -1)
        pick = torch.randint(0, len(pool), (t.shape[1],), generator=gen,
                             device=dev)
        use = torch.rand(t.shape[1], generator=gen, device=dev) < 0.75
        t[:, use] = pool_t[:, pick[use]]
        return t.reshape((16,) + shape)

    def as_tuple(x):
        return tuple(x) if isinstance(x, (tuple, list)) else (x,)

    # each kernel's wrapper and plain version, taken before phase 6 wraps
    # the wrappers where the prover looks them up
    KERNEL = {
        "mont_mul": (fk.mont_mul, arith.mont_mul),
        "mont_mul_bl": (fk.mont_mul_bl, fk.mont_mul_bl_plain),
        "gp_pair_evals": (fk.gp_pair_evals, fk.gp_pair_evals_plain),
        "gp_pair_bind": (fk.gp_pair_bind, fk.gp_pair_bind_plain),
        "proj_cadd": (ck.proj_cadd, ck.proj_cadd_plain),
        "jac_add": (ck.jac_add, ck.jac_add_plain),
        "jac_double": (ck.jac_double, lambda p: ck.jac_double_plain(*p)),
        "transcript_events": (kd.transcript_events,
                              kd.transcript_events_plain),
        "fs_round": (fsd.fs_round, fsd.fs_round_plain),
        "field_addsub": (fk.field_addsub, fk.field_addsub_plain),
        "field_sum": (fk.field_sum, fk.field_sum_plain),
        "primary_round": (il.primary_round, il.primary_round_plain),
        "toggle_evals": (fk.toggle_evals, fk.toggle_evals_plain),
        "bind_halves": (fk.bind_halves, fk.bind_halves_plain),
        "reduction_evals": (fk.reduction_evals, fk.reduction_evals_plain),
        "rlc": (fk.rlc, fk.rlc_plain)}
    results = {}                    # {kernel: {phase: row}}
    more = {}                       # {kernel: [rows at further shapes]}
    launch = {}                     # the launch floor, measured with K8

    def latency_ms(name, args):
        """(the work's chain, the design's chain) of one call of a kernel
        that a dependent chain bounds (K8, K9, the round), each in ms at
        4 cycles a level and the card's clock, with one launch: for K8
        and K9 the design's is one thread running all of it, for the
        round the group plan's."""
        chain, design = (round_chain_levels(args) if name == "primary_round"
                         else fs_chain_levels(name, args))
        return tuple(lv * DEP_CYCLES / clock_hz * 1e3 + launch["ms"]
                     for lv in (chain, design))

    def least_ms(name, args, floor=0.0):
        """The least time of one call: the larger of its bytes, its
        operations and, where one bounds it (K8, K9, the round), its
        chain, which holds one launch already; `floor` (one launch) is
        added to the bytes and the operations."""
        return max(*(b + floor
                     for b in call_bounds(name, args, imad_rate)[2:]),
                   *(latency_ms(name, args)[:1] if name in CHAIN_KERNELS
                     else ()))

    def compare(phase, name, shape, args, record=True, time_plain=True):
        """The kernel against its plain version on `args`, then each
        timed (the plain version only where `time_plain`: the round's
        plain version takes seconds a call, so its further shapes are
        compared, not timed)."""
        wrapper, plain = KERNEL[name]
        got = as_tuple(wrapper(*args))
        want = as_tuple(plain(*args))
        torch.cuda.synchronize()
        err = max((int((g.long() - w.long()).abs().max()) for g, w in
                   zip(got, want) if g.numel()), default=0)
        if err != 0 or any(g.shape != w.shape for g, w in zip(got, want)):
            fail(f"{name} at {shape}: kernel and plain version differ (max "
                 f"abs err {err})")
        del got, want
        kernel_ms = event_ms(lambda: wrapper(*args), 10)
        plain_ms = (event_ms(lambda: plain(*args), 1, warm=True)
                    if time_plain else None)
        nbytes, muls, bytes_ms, ops_ms = call_bounds(name, args, imad_rate)
        bound_ms = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        plain_txt = "not timed" if plain_ms is None else f"{plain_ms:.2f}"
        print(f"{phase}: {name} shape={shape} kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_txt} bytes={nbytes} "
              f"bytes_bound_ms={bytes_ms:.4f} int32_muls={muls} "
              f"ops_bound_ms={ops_ms:.4f} bound_by={bound_by} "
              f"max_abs_err={err}", flush=True)
        row = dict(phase=phase, shape=shape, max_abs_err=err, ms=kernel_ms,
                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)
        if name == "primary_round":
            # the work's dependent chain and one launch, beside the group
            # plan's chain: what bounds the round at small h
            chain, design = round_chain_levels(args)
            row["latency_bound_ms"], row["plan_latency_bound_ms"] = \
                latency_ms(name, args)
            row["launch_ms"] = launch["ms"]
            points, split, tiles, blocks = il.round_plan(
                args[0], args[1].shape[-1])
            print(f"{phase}: {name} shape={shape} latency_bound_ms="
                  f"{row['latency_bound_ms']:.4f} ({chain} levels: the "
                  f"work's chain; one launch {launch['ms']:.4f} ms); the "
                  f"group plan's chain {design} levels, "
                  f"{row['plan_latency_bound_ms']:.4f} ms; INT32 bound "
                  f"{ops_ms:.4f} ms, bytes bound {bytes_ms:.4f} ms; "
                  f"{blocks} blocks ({tiles} tiles x split {split}, "
                  f"{points} points)", flush=True)
        if name in FS_KERNELS:
            # the work's dependent chain and one launch: what bounds K8
            # and K9 in fact; beside it the one-thread chain
            _, prods, perms = fs_work(name, args)
            chain, serial = fs_chain_levels(name, args)
            row["latency_bound_ms"], row["serial_latency_bound_ms"] = \
                latency_ms(name, args)
            row["launch_ms"] = launch["ms"]
            print(f"{phase}: {name} shape={shape} latency_bound_ms="
                  f"{row['latency_bound_ms']:.4f} ({chain} levels: "
                  f"{perms} permutations, and the products on the chain; "
                  f"one launch {launch['ms']:.4f} ms); with all {prods} "
                  f"products on the chain, as one thread runs them, "
                  f"{row['serial_latency_bound_ms']:.4f}", flush=True)
        if record:
            results.setdefault(name, {})[phase] = row
        else:                           # more shapes, kept beside the row
            more.setdefault(name, []).append(row)

    n = 1 << NV
    # K1, Fr: the witness's to-Montgomery pass, [16, 4, 2^20] x R^2
    a = rand_fe(FR, 4, n)
    r2 = arith.const_limbs(FR, "r2", dev).reshape(16, 1, 1)
    compare("phase 2", "mont_mul", "[16,4,2^20] x [16,1,1] Fr", (FR, a, r2))
    del a
    # K1, Fq: Jacobian -> projective of the SRS, [16, 2^20] x [16, 2^20]
    a, b = rand_fe(FQ, n), rand_fe(FQ, n)
    compare("phase 2", "mont_mul", "[16,2^20] x [16,2^20] Fq", (FQ, a, b),
            record=False)
    del a, b
    # K4, K2, K3: the read/write GP's leaf layer, B = 8, s = 2^19
    B, s = 8, n // 2
    pair = rand_fe(FR, B, 2 * s).movedim(0, 1).contiguous()   # [8, 16, 2^20]
    l, r = pair[..., :s], pair[..., s:]
    eq = rand_fe(FR, s)
    coeffs = rand_fe(FR, B)
    compare("phase 2", "mont_mul_bl", "[8,16,2^19] x [8,16,2^19] Fr",
            (FR, l, r))
    compare("phase 2", "gp_pair_evals",
            "l,r [8,16,2^19], eq [16,2^19], coeffs [16,8]",
            (FR, l, r, eq, coeffs))
    rc = fd.scalar_to_device(FR, 0x1234567 ** 9, "cpu")
    compare("phase 2", "gp_pair_bind",
            "l,r [8,16,2^19], eq [16,2^19] -> halves", (FR, l, r, eq, rc))
    del pair, l, r, eq
    # K2 at the fib GP's batch: its largest round and two small ones (the
    # small rounds show the per-launch floor), then on edge residues
    for Bk, sk in [(b, k) for b in (43, 64) for k in (15, 9, 5)] + [(43, 12)]:
        mk = edge_fe if sk == 12 else rand_fe
        lk = mk(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        rk = mk(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        compare("phase 2", "gp_pair_evals",
                f"l,r [{Bk},16,2^{sk}], eq [16,2^{sk}], coeffs [16,{Bk}]"
                + (" edge residues" if sk == 12 else ""),
                (FR, lk, rk, mk(FR, 1 << sk), mk(FR, Bk)), record=False)
        del lk, rk
    # K2 at the full VM's batches (its GPs' 110 and 81 circuits; 128, the
    # kernel's cap; 200, split over two launches) and K3 at B = 110
    for Bk, sk in [(b, k) for b in (65, 81, 110, 128, 200) for k in (15, 5)]:
        lk = rand_fe(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        rk = rand_fe(FR, Bk, 1 << sk).movedim(0, 1).contiguous()
        eqk = rand_fe(FR, 1 << sk)
        compare("phase 2", "gp_pair_evals",
                f"l,r [{Bk},16,2^{sk}], eq [16,2^{sk}], coeffs [16,{Bk}]",
                (FR, lk, rk, eqk, rand_fe(FR, Bk)), record=False)
        if Bk == 110:
            compare("phase 2", "gp_pair_bind",
                    f"l,r [{Bk},16,2^{sk}], eq [16,2^{sk}] -> halves",
                    (FR, lk, rk, eqk, rc), record=False)
        del lk, rk, eqk
    # K5, K6 on real points: the 2^17-point SRS fixture, tiled
    with np.load(ROOT / "fixtures" / "srs" / "srs_131072_6a6f6c74.npz") as z:
        fix = {k: z[k] for k in ("X", "Y", "Z")}
    X, Y, Z = (torch.from_numpy(fix[k].astype(np.int32)).to(dev)
               for k in ("X", "Y", "Z"))
    m = X.shape[1]
    # K5: one fold step, accumulators [16, T, K] with K = 64 channels
    K = MSM_CHANNEL_CHUNK
    T = FOLD_LANES // K
    PX, PZ = fd.fmul(FQ, X, Z), fd.fmul(FQ, Z, fd.fmul(FQ, Z, Z))
    proj = [t.reshape(16, -1)[:, :T * K // 8].repeat(1, 8).reshape(16, T, K)
            .contiguous() for t in (PX, Y, PZ)]
    perm = torch.randperm(T * K, generator=gen, device=dev)
    other = [t.reshape(16, -1)[:, perm].reshape(16, T, K).contiguous()
             for t in proj]
    other[0][:, 0], other[1][:, 0], other[2][:, 0] = \
        proj[0][:, 0], proj[1][:, 0], proj[2][:, 0]            # doubling
    other[0][:, 1], other[2][:, 1] = 0, 0                      # (0:1:0)
    other[1][:, 1] = arith.const_limbs(FQ, "r", dev)[:, None]
    other[0][:, 2], other[2][:, 2] = proj[0][:, 2], proj[2][:, 2]
    other[1][:, 2] = arith.sub(FQ, torch.zeros_like(proj[1][:, 2]),
                               proj[1][:, 2])                  # P + (-P)
    p1, p2 = tuple(proj), tuple(other)
    compare("phase 2", "proj_cadd", f"[16,{T},{K}] x 6 -> 3 Fq", (p1, p2))
    p1 = tuple(edge_fe(FQ, T, K) for _ in range(3))
    p2 = tuple(edge_fe(FQ, T, K) for _ in range(3))
    compare("phase 2", "proj_cadd", f"[16,{T},{K}] x 6 -> 3 Fq edge residues",
            (p1, p2), record=False)
    del proj, other, p1, p2, PX, PZ
    # K6: the first tree level of SRS generation, [16, 16, 2^18]
    W2, C = 16, 1 << 18
    idx = torch.randint(0, m, (2, W2 * C), generator=gen, device=dev)
    q1 = [t[:, idx[0]].reshape(16, W2, C) for t in (X, Y, Z)]
    q2 = [t[:, idx[1]].reshape(16, W2, C) for t in (X, Y, Z)]
    for k in range(3):
        q2[k][:, 0, :64] = q1[k][:, 0, :64]                    # doubling
    q2[1][:, 1, :64] = arith.sub(FQ, torch.zeros_like(q1[1][:, 1, :64]),
                                    q1[1][:, 1, :64])          # inverse
    for k in (0, 2):
        q2[k][:, 1, :64] = q1[k][:, 1, :64]
    q2[2][:, 2, :64] = 0                                       # P2 = infinity
    q1[2][:, 3, :64] = 0                                       # P1 = infinity
    p1, p2 = tuple(q1), tuple(q2)
    compare("phase 2", "jac_add", f"[16,{W2},2^18] x 6 -> 3 Fq", (p1, p2))
    del q1, q2, p1, p2, idx
    # K7: the SRS fixture tiled to [16, 2^20], with Z = 0 lanes
    reps = n // m
    pd = [t.repeat(1, reps).contiguous() for t in (X, Y, Z)]
    pd[2][:, ::97] = 0                                         # infinity
    pt = tuple(pd)
    compare("phase 2", "jac_double", "[16,2^20] x 3 -> 3 Fq", (pt,))
    del pd, pt
    torch.cuda.empty_cache()
    # K8, K9: the device Fiat-Shamir kernels.  The launch floor: a
    # one-element kernel, launched back to back
    launch["ms"] = launch_floor_ms()
    print(f"phase 2: one launch (a one-element kernel, back to back) "
          f"{launch['ms']:.4f} ms", flush=True)
    # K8 over 1,024 chained events, launch by launch against its plain
    # version on the card and the host transcript
    host8 = Transcript(b"chip_smoke K8")
    st8 = fsd.state_to_device(host8, dev)
    rng8 = random.Random(8)
    pool8 = [0, 1, FR.p - 1, FR.r]
    done8 = n8 = big8 = 0
    t0 = time.perf_counter()
    while done8 < 1024:
        segs = [(rng8.choice((kd.APPEND, kd.CHALLENGE)), rng8.randrange(17))
                for _ in range(rng8.randrange(1, kd.MAX_SEGS + 1))]
        n_app = sum(c for k, c in segs if k == kd.APPEND)
        vals = [rng8.choice(pool8) if rng8.random() < 0.5
                else rng8.randrange(FR.p) for _ in range(max(n_app, 1))]
        sc8 = fd.ints_to_device(FR, vals, dev)
        got8 = kd.transcript_events(FR, st8, sc8, segs)
        want8 = kd.transcript_events_plain(FR, st8, sc8, segs)
        torch.cuda.synchronize()
        if not all(torch.equal(g.long(), w.long())
                   for g, w in zip(got8, want8)):
            fail(f"transcript_events: launch {n8} differs from its plain "
                 "version")
        col, chals = 0, []
        for kind, count in segs:
            for _ in range(count):
                if kind == kd.APPEND:
                    host8.append_scalar(FElt(vals[col], FR))
                    col += 1
                else:
                    chals.append(host8.challenge_scalar().v)
                    big8 += int.from_bytes(host8.state, "big") >= 5 * FR.p
        if fsd.state_bytes(got8[0]) != (host8.state, host8.n_rounds) or \
                [int(v) for v in fd.device_to_ints(FR, got8[1]).tolist()] \
                != chals:
            fail(f"transcript_events: launch {n8} differs from the host "
                 "transcript")
        st8 = got8[0]
        done8 += sum(c for _, c in segs)
        n8 += 1
    if big8 == 0:
        fail("transcript_events: no challenge digest in [5p, 2^256) was met")
    print(f"phase 2: transcript_events over {done8} chained events in {n8} "
          f"launches == its plain version == the host transcript ({big8} "
          f"challenge digests in [5p, 2^256); "
          f"{time.perf_counter() - t0:.2f} s)", flush=True)
    # K8 at the main path's shapes: the full VM's toggled GP draws 110
    # coefficients and appends 220 claims per layer
    compare("phase 2", "transcript_events", "110 challenges (state [9])",
            (FR, st8, None, [(kd.CHALLENGE, 110)]))
    compare("phase 2", "transcript_events", "220 appends of [16,220] edge "
            "residues", (FR, st8, edge_fe(FR, 220), [(kd.APPEND, 220)]),
            record=False)
    compare("phase 2", "transcript_events", "a chained GKR layer: 220 "
            "appends of [16,220] edge residues, 1 challenge, 110 "
            "challenges", (FR, st8, edge_fe(FR, 220),
                           [(kd.APPEND, 220), (kd.CHALLENGE, 1),
                            (kd.CHALLENGE, 110)]), record=False)
    # K9: the GKR and toggle rounds (d = 3), the opening reduction (d = 2),
    # both with the hint, the full VM's primary sumcheck (d = 8), and
    # degrees past it (9 with the hint, 12 without), whose buffers K9
    # sizes at launch
    prev9 = edge_fe(FR, 1)[:, 0]
    for d9, hint9, n9 in ((3, True, 3), (2, True, 2), (8, False, 9),
                          (9, True, 9), (12, False, 13)):
        compare("phase 2", "fs_round", f"d = {d9}, evals [16,{n9}] edge "
                f"residues" + (", the hint" if hint9 else ""),
                (FR, edge_fe(FR, n9), prev9, st8, d9, hint9),
                record=d9 == 3)
    # K10 and K11, the field programs, at the primary sumcheck's first
    # round on rv32i_vm() (T = 2^16, 55 memories): K10 on e_t's halves (views,
    # element stride 1, batch stride 2^16), on a broadcast constant (DevF's
    # coerced ints), on edge residues and a = b
    h16 = 1 << 15
    e16 = rand_fe(FR, 55, 2 * h16)
    lo16, hi16 = e16[..., :h16], e16[..., h16:]
    compare("phase 2", "field_addsub", "[16,55,2^15] + [16,55,2^15], the "
            "halves of [16,55,2^16]", (FR, lo16, hi16, fk.ADD))
    compare("phase 2", "field_addsub", "[16,55,2^15] - [16,55,2^15], the "
            "halves of [16,55,2^16]", (FR, hi16, lo16, fk.SUB), record=False)
    one16 = arith.const_limbs(FR, "r", dev).reshape(16, 1, 1)
    compare("phase 2", "field_addsub", "[16,55,2^15] half - [16,1,1] "
            "broadcast constant", (FR, lo16, one16, fk.SUB), record=False)
    ed16, ee16 = edge_fe(FR, 55, 1 << 12), edge_fe(FR, 55, 1 << 12)
    for what, a16, b16, op16 in (("+", ed16, ee16, fk.ADD),
                                 ("-", ed16, ee16, fk.SUB),
                                 ("- a = b:", ed16, ed16, fk.SUB),
                                 ("neg", ed16, ed16, fk.NEG)):
        compare("phase 2", "field_addsub", f"[16,55,2^12] {what} edge "
                "residues", (FR, a16, b16, op16), record=False)
    # K11: the sha2-chain prove's largest sum, one row of 2^23 terms (cut
    # into a wave of segments), one of 2^20, the leading axis of [16, 110,
    # 2^15] (a lane a row, 8 warps along the terms), lengths 1 and 3
    compare("phase 2", "field_sum", "[16,2^23] along -1",
            (FR, rand_fe(FR, 8 * n), -1))
    compare("phase 2", "field_sum", "[16,2^20] along -1",
            (FR, rand_fe(FR, n), -1), record=False)
    compare("phase 2", "field_sum", "[16,110,2^15] along 0",
            (FR, rand_fe(FR, 110, h16), 0), record=False)
    compare("phase 2", "field_sum", "[16,55,1] along -1 edge residues",
            (FR, edge_fe(FR, 55, 1), -1), record=False)
    compare("phase 2", "field_sum", "[16,3] along -1 edge residues",
            (FR, edge_fe(FR, 3), -1), record=False)
    # The primary round's kernel on rv32i_vm()'s preprocessing (29
    # instructions, 55 memories): the first round (E [16, 55, 2^16], flags
    # [16, 29, 2^16], eq and out [16, 2^16]; h = 2^15), h = 2^12, the last
    # rounds' h = 2 and 1 on edge residues, the mini VM's two instructions,
    # and one shard of a 2-shard mesh's first round (cyclic: the odd
    # entries, h = 2^14), each one launch
    pre13 = il.InstructionLookupsPreprocessing(
        RV32I_INSTRUCTIONS, RV32I_SUBTABLES, 4, 1 << 16, dev, FR)
    prog13 = collation.program(pre13)
    plan13 = prog13.plan
    print(f"phase 2: primary_round's program for rv32i_vm(): "
          f"{len(prog13.rows)} rows, {prog13.products} Montgomery products "
          f"and {prog13.adds} adds or subtracts an element and point, "
          f"{len(prog13.consts)} constants, {len(prog13.columns)} memories "
          f"and {prog13.n_flags} flags read; its group plan: "
          f"{plan13.n_groups} groups {[list(g) for g in plan13.groups]}, "
          f"chain levels {list(plan13.levels)}, slots "
          f"{list(plan13.group_slots)}, {len(plan13.stage)} staged "
          f"columns, {plan13.smem_bytes()} B of shared memory a block",
          flush=True)
    f16, eq16, out16 = (rand_fe(FR, 29, 2 * h16), rand_fe(FR, 2 * h16),
                        rand_fe(FR, 2 * h16))
    compare("phase 2", "primary_round", "the first round: E [16,55,2^16], "
            "flags [16,29,2^16], eq, out [16,2^16]",
            (pre13, eq16, out16, f16, e16))
    h12 = 1 << 12
    compare("phase 2", "primary_round", "E [16,55,2^13], flags "
            "[16,29,2^13], eq, out [16,2^13] (h = 2^12)",
            (pre13, rand_fe(FR, 2 * h12), rand_fe(FR, 2 * h12),
             rand_fe(FR, 29, 2 * h12), rand_fe(FR, 55, 2 * h12)),
            record=False, time_plain=False)
    for h13 in (2, 1):
        compare("phase 2", "primary_round", f"h = {h13}: E [16,55,{2 * h13}],"
                f" flags [16,29,{2 * h13}], eq, out [16,{2 * h13}] edge "
                "residues", (pre13, edge_fe(FR, 2 * h13), edge_fe(FR, 2 * h13),
                             edge_fe(FR, 29, 2 * h13),
                             edge_fe(FR, 55, 2 * h13)),
                record=False, time_plain=False)
    vm13 = cli.fib_vm(FIB_M)
    fib13 = il.InstructionLookupsPreprocessing(
        vm13.instruction_classes, vm13.subtable_order, vm13.C, vm13.M, dev,
        FR)
    compare("phase 2", "primary_round", f"the mini VM (ADD, BNE; degree "
            f"{fib13.sumcheck_degree}): E [16,{fib13.num_memories},2^14], "
            f"flags [16,2,2^14], eq, out [16,2^14] edge residues",
            (fib13, edge_fe(FR, 1 << 14), edge_fe(FR, 1 << 14),
             edge_fe(FR, 2, 1 << 14),
             edge_fe(FR, fib13.num_memories, 1 << 14)),
            record=False, time_plain=False)
    mesh13 = sh.make_mesh(2, device=dev)
    shard13 = [sh.maybe_shard_hypercube(mesh13, t).shards[1]
               for t in (eq16, out16, f16, e16)]
    compare("phase 2", "primary_round", "one shard of a 2-shard mesh's "
            "first round: " + ", ".join(
                f"{list(t.shape)} strides {list(t.stride())}"
                for t in shard13), (pre13, *shard13), record=False,
            time_plain=False)
    del shard13, mesh13
    # K14-K17 at the sha2 prove's shapes (rv32i_vm(), T = 2^16, 55
    # memories): the toggle round's first round (flags Montgomery 0/1,
    # [16, 55, 2^16]; fingerprints [16, 110, 2^16]) and its last (s = 2,
    # edge residues), its binds (flags, fingerprints, eq in one launch, the
    # challenge on the card as K9 leaves it); the reduction's first round
    # (its 4 openings of 2^16 active, the constant by value) and its binds,
    # 17 pairs (two launches) and n = 2 on edge residues; the first
    # append's RLC (85 columns of E [16, 55, 2^16], flags [16, 29, 2^16]
    # and the outputs, read in place) and HyperKZG's (16 polynomials of
    # 2^16 .. 2, padded to 2^16), 50 polynomials (two launches) on edge
    # residues
    bits14 = torch.randint(0, 2, (55, 2 * h16), generator=gen, device=dev,
                           dtype=torch.int32).bool()
    flags14 = torch.where(bits14[None], one16, 0).to(torch.int32)
    fps14, eq14, co14 = (rand_fe(FR, 110, 2 * h16), rand_fe(FR, 2 * h16),
                         rand_fe(FR, 110))
    del bits14
    compare("phase 2", "toggle_evals", "the first round: flags [16,55,2^16] "
            "Montgomery 0/1, fingerprints [16,110,2^16], eq [16,2^16], "
            "coeffs [16,110]", (FR, flags14, fps14, eq14, co14))
    compare("phase 2", "toggle_evals", "the last round: flags [16,55,2], "
            "fingerprints [16,110,2], eq [16,2] edge residues",
            (FR, edge_fe(FR, 55, 2), edge_fe(FR, 110, 2), edge_fe(FR, 2),
             edge_fe(FR, 110)), record=False)
    compare("phase 2", "toggle_evals", "flags [16,55,2^12], fingerprints "
            "[16,110,2^12], eq [16,2^12] edge residues",
            (FR, edge_fe(FR, 55, 1 << 12), edge_fe(FR, 110, 1 << 12),
             edge_fe(FR, 1 << 12), edge_fe(FR, 110)), record=False)
    rj14 = edge_fe(FR, 1)[:, 0]
    compare("phase 2", "bind_halves", "the toggle's first round: flags "
            "[16,55,2^16], fingerprints [16,110,2^16], eq [16,2^16] -> "
            "halves, the challenge on the card",
            (FR, (flags14, fps14, eq14), rj14))
    compare("phase 2", "bind_halves", "the toggle's last round: [16,55,2], "
            "[16,110,2], [16,2] edge residues -> halves",
            (FR, (edge_fe(FR, 55, 2), edge_fe(FR, 110, 2), edge_fe(FR, 2)),
             rc), record=False)
    del flags14, fps14, eq14, co14
    n16 = 2 * h16
    p16 = [rand_fe(FR, n16) for _ in range(4)]
    q16 = [rand_fe(FR, n16) for _ in range(4)]
    c16 = fk.host_limbs(FR, [FR.p - 1 - a for a in range(4)])
    k16 = fk.host_limbs(FR, [0x1234567 ** 9])[:, 0]
    compare("phase 2", "reduction_evals", "the first round: 4 pairs "
            "[16,2^16] x 2", (FR, p16, q16, c16, k16))
    compare("phase 2", "bind_halves", "the reduction's first round: 8 x "
            "[16,2^16] -> halves, the challenge by value",
            (FR, p16 + q16, rc), record=False)
    del p16, q16
    for A16, nn in ((17, 1 << 10), (3, 2)):
        compare("phase 2", "reduction_evals", f"{A16} pairs [16,{nn}] x 2 "
                "edge residues", (FR, [edge_fe(FR, nn) for _ in range(A16)],
                                  [edge_fe(FR, nn) for _ in range(A16)],
                                  fk.host_limbs(FR, range(1, A16 + 1)),
                                  fk.host_limbs(FR, [FR.p - 1])[:, 0]),
                record=False)
    E17, F17, o17 = rand_fe(FR, 55, n16), rand_fe(FR, 29, n16), \
        rand_fe(FR, n16)
    cols17 = [E17[:, i] for i in range(55)] + [F17[:, i] for i in
                                                range(29)] + [o17]
    compare("phase 2", "rlc", "the first append: 85 polynomials of 2^16, "
            "columns of [16,55,2^16] and [16,29,2^16] read in place",
            (FR, cols17, fk.host_limbs(FR, range(7, 7 + 85)), n16))
    del E17, F17, o17, cols17
    kzg17 = [rand_fe(FR, n16 >> j) for j in range(16)]
    compare("phase 2", "rlc", "HyperKZG's: 16 polynomials of 2^16 .. 2, "
            "padded to 2^16", (FR, kzg17, fk.host_limbs(FR, range(3, 19)),
                               n16), record=False)
    compare("phase 2", "rlc", "50 polynomials of 2^10, 2^9 edge residues, "
            "padded to 2^11", (FR, [edge_fe(FR, 1024 >> (i % 2)) for i in
                                    range(50)],
                               fk.host_limbs(FR, range(5, 55)), 2048),
            record=False)
    del kzg17
    # each wrapper's host time per call (enqueue only, at a size whose
    # kernel is shorter than its wrapper), as the primary round and the
    # toggle and reduction rounds call them
    sm16 = rand_fe(FR, 55, 128)
    c2 = rand_fe(FR, 2)
    for name, args in (
            ("field_addsub", (FR, sm16[..., :64], sm16[..., 64:], fk.ADD)),
            ("field_addsub", (FR, sm16[:, 0, :64], one16[:, 0], fk.SUB)),
            ("field_sum", (FR, sm16[:, 0], -1)),
            ("primary_round", (pre13, eq16[:, :4], out16[:, :4],
                               f16[..., :4], e16[..., :4])),
            ("toggle_evals", (FR, sm16[:, :1, :4], sm16[:, 1:3, :4],
                              sm16[:, 3, :4], c2)),
            ("bind_halves", (FR, (sm16[:, :1, :4], sm16[:, 1:3, :4],
                                  sm16[:, 3, :4]), rj14)),
            ("reduction_evals", (FR, [sm16[:, a, :4] for a in range(4)],
                                 [sm16[:, 4 + a, :4] for a in range(4)],
                                 c16, k16)),
            ("rlc", (FR, [sm16[:, a, :4] for a in range(8)],
                     fk.host_limbs(FR, range(8)), 4))):
        fn = KERNEL[name][0]
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn(*args)
        host16 = (time.perf_counter() - t0) / 200 * 1e3
        torch.cuda.synchronize()
        results[name]["phase 2"].setdefault("host_ms", host16)
        print(f"phase 2: {name} host_ms per call {host16:.4f} (the "
              f"wrapper's enqueue, no sync; " + " x ".join(
                  str(list(t.shape)) for t in args[1:]
                  if isinstance(t, torch.Tensor)) + ")", flush=True)
    del e16, lo16, hi16, ed16, ee16, eq16, out16, sm16, f16, pre13, fib13
    torch.cuda.empty_cache()

    phase_done("phase 2")

    # -- phase 3: the main path begins: SRS setup -----------------------
    nat.reset_launch_counts()
    t0 = time.perf_counter()
    pre, pcs = cli.surge_setup(NV, dev)
    setup_s = time.perf_counter() - t0
    gX, gY, gZ = pcs.pk.g1_jac
    for k, t in zip(("X", "Y", "Z"), (gX, gY, gZ)):
        got = t[:, :m].cpu().numpy().astype(np.uint32)
        if got.shape != fix[k].shape or not (got == fix[k]).all():
            fail(f"SRS coordinate {k}: first 2^17 points differ from the "
                 "fixture")
    print(f"phase 3: HyperKZG setup with a 2^{NV}-point SRS generated on the "
          f"card (+ XOR subtables): {setup_s:.3f} s; first 2^17 points equal "
          f"srs_131072_6a6f6c74.npz (X, Y, Z) [{card}]", flush=True)

    phase_done("phase 3")

    # -- phase 4: Surge XOR, nv = 20 --------------------------------------
    x, y = cli.surge_inputs(np.random.default_rng(0), NV)
    t0 = time.perf_counter()
    proof, transcript, _ = surge_prove(pre, pcs, x, y)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    main_counts = nat.launch_counts()
    print(f"phase 4: warm-up prove {warm_s:.3f} s; main-path launches "
          f"(setup + this prove) {json.dumps(main_counts)}", flush=True)
    missing = [k for k, v in main_counts.items()
               if v <= 0 and k not in OFF_PATH and k not in OFF_SURGE]
    if missing:
        fail(f"kernels of the main path never launched: {missing}")
    surge_verify(pre, proof, debug_transcript=transcript)
    good = proof.primary_sumcheck.claimed_evaluation
    proof.primary_sumcheck.claimed_evaluation = good + FElt(1, FR)
    try:
        surge_verify(pre, proof)
    except VerificationError:
        pass
    else:
        fail("a proof with its claimed evaluation bumped by one verified")
    proof.primary_sumcheck.claimed_evaluation = good
    nat.reset_launch_counts()
    t0 = time.perf_counter()
    proof, transcript, _ = surge_prove(pre, pcs, x, y)
    torch.cuda.synchronize()
    prove_s = [time.perf_counter() - t0]
    prove_counts = nat.launch_counts()
    t0 = time.perf_counter()
    for _ in range(3):
        surge_verify(pre, proof, debug_transcript=transcript)
    verify_s = (time.perf_counter() - t0) / 3
    print(f"phase 4: Surge XOR nv={NV} C=4 M=2^16: prove_s={prove_s} "
          f"verify_s={verify_s:.4f} (avg of 3), tampered proof rejected, "
          f"peak_mem_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"[{card}]", flush=True)
    print(f"phase 4: launches per nv={NV} prove {json.dumps(prove_counts)}",
          flush=True)
    print(f"phase 4: Surge XOR nv={NV} proof_size_bytes="
          f"{len(serialize_surge_proof(proof, pre.num_memories))} "
          "(arkworks SurgeProof bytes)", flush=True)

    phase_done("phase 4")

    # -- phase 5: reference on a small input ------------------------------
    xs, ys = cli.surge_inputs(np.random.default_rng(1), 10)
    runs = {}
    for d in (dev, torch.device("cpu")):
        pre_s = SurgePreprocessing(XorInstruction, 4, 1 << 8, device=d)
        pcs_s = HyperKZG.setup(1 << 10, device=d)
        p, tr, _ = surge_prove(pre_s, pcs_s, xs, ys)
        surge_verify(pre_s, p, debug_transcript=tr)
        runs[d.type] = (tr.state_history,
                        [c.point for c in p.commitments + p.final_commitments])
    if runs["cuda"] != runs["cpu"]:
        fail("Surge nv=10: card and CPU transcripts or commitments differ")
    polys, _ = generate_witness(pre_s, xs, ys)
    pts = [G1Jacobian(int(a), int(b), int(c)) for a, b, c in zip(
        *(fd.unpack_ints(fd.from_mont_device(FQ, t).numpy()) for t in
          pcs_s.pk.g1_jac))]
    for j in (0, 8):                    # dim_0 and E_0 against a host MSM
        scal = fd.device_to_ints(FR, polys.read_write_values()[j])
        acc = G1Jacobian.identity()
        for pt, sc in zip(pts, scal):
            acc = acc.add(pt.mul(int(sc)))
        if acc.to_affine() != runs["cuda"][1][j]:
            fail(f"Surge nv=10: commitment {j} differs from the host MSM")
    print("phase 5: Surge nv=10 card == CPU (transcript, 16 commitments); "
          "2 commitments == host MSM", flush=True)

    phase_done("phase 5")

    # -- phases 6, 8 and 10: the Jolt VM's main paths ---------------------
    # Through setup and the prove, each kernel's wrapper is wrapped
    # where the prover's modules look it up (field/kernels.py for K1-K4,
    # curve/device.py for K5-K7), keeping a copy of the inputs of its
    # largest call on the card (with `by_batch`, K2's and K3's largest at
    # each batch size); the copies are replayed against the plain versions.
    sites = {name: (fk if name in ("mont_mul", "mont_mul_bl",
                                   "gp_pair_evals", "gp_pair_bind",
                                   "field_addsub", "field_sum")
                    + SUMCHECK_KERNELS
                    else kd if name == "transcript_events"
                    else fsd if name == "fs_round"
                    else il if name == "primary_round"
                    else cd)
             for name in KERNEL}

    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (tuple, list)):
            for y in x:
                yield from tensors(y)

    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, (tuple, list)):
            return type(x)(copy(y) for y in x)
        return x

    def fs_shape(name, args):
        """A K8 or K9 call's shape, which fixes its work: K8's segments
        (and whether it appends), K9's degree, hint and evaluations."""
        if name == "transcript_events":
            return tuple(map(tuple, args[3])), args[2] is None
        return args[4], args[5], args[1].shape[1]

    def start_recording(by_batch, fs_calls=None, bound_sums=None,
                        sum_calls=None):
        """Wrap each kernel's wrapper at its sites; returns the dict that
        the wrapped calls fill with the inputs of the largest calls.  With
        `fs_calls`, K8's and K9's calls are also counted by shape there,
        with a copy of each shape's first inputs; with `bound_sums`, each
        kernel's calls, the sum of their bounds (ms) and that sum with one
        launch a call are kept there; with `sum_calls`, a copy of every
        K11 call's inputs, strides kept (strided_copy)."""
        largest = {}

        def keep_largest(name, fn):
            def wrapped(*args):
                ts = list(tensors(args))
                size = max(t.numel() for t in ts)
                key = (name, args[1].shape[0] if by_batch and
                       name in GP_KERNELS else 0)
                if ts[0].is_cuda and size > largest.get(key, (0, None))[0]:
                    largest[key] = (size, copy(args))
                if fs_calls is not None and name in FS_KERNELS:
                    shape = (name, fs_shape(name, args))
                    count, first = fs_calls.get(shape, (0, None))
                    fs_calls[shape] = (count + 1, first or copy(args))
                if bound_sums is not None and ts[0].is_cuda:
                    rec = bound_sums.setdefault(name, [0, 0.0, 0.0])
                    rec[0] += 1
                    rec[1] += least_ms(name, args)
                    rec[2] += least_ms(name, args, launch["ms"])
                if (sum_calls is not None and name == "field_sum"
                        and ts[0].is_cuda):
                    sum_calls.append((args[0], strided_copy(args[1]),
                                      args[2]))
                return fn(*args)
            return wrapped

        for name, mod in sites.items():
            setattr(mod, name, keep_largest(name, KERNEL[name][0]))
        return largest

    def stop_recording():
        for name, mod in sites.items():
            setattr(mod, name, KERNEL[name][0])

    def check_and_replay(phase, label, counts, largest,
                         required=VM_KERNELS):
        """The `required` kernels (K1-K5 for a VM path) must have launched,
        every launch through the recording wrappers; then each recorded
        call is replayed against the plain version (the largest of each
        kernel is its row for this path)."""
        missing = [k for k in required if counts[k] <= 0]
        if missing:
            fail(f"kernels of the {label} path never launched: {missing}")
        unseen = [k for k, v in counts.items()
                  if v and k not in {n for n, _ in largest}]
        if unseen:
            fail(f"launches that bypassed the recording wrappers: {unseen}")
        top = {name: max((key for key in largest if key[0] == name),
                         key=lambda key: largest[key][0])
               for name in {n for n, _ in largest}}
        for key in sorted(largest, key=lambda k: (list(KERNEL).index(k[0]),
                                                  -k[1])):
            name, args = key[0], largest.pop(key)[1]
            shape = " x ".join(str(list(t.shape)) for t in tensors(args))
            if isinstance(args[0], FieldSpec):
                shape += f" {args[0].name}"
            compare(f"{phase} {label}", name, shape, args,
                    record=key == top[name],
                    time_plain=name != "primary_round")
            del args
        torch.cuda.empty_cache()

    def held_gb(largest):
        """Device memory of the recorded copies, in GB."""
        return sum(t.numel() * t.element_size() for _, args in
                   largest.values() for t in tensors(args)) / 1e9

    def fs_device_ms(phase, label, fs_calls, counts):
        """K8's and K9's launches in one prove and their summed device ms:
        each shape's calls times its kernel's time on the card alone at
        that shape (their work does not depend on the values)."""
        for name in FS_KERNELS:
            shapes = [(c, args) for (n, _), (c, args) in fs_calls.items()
                      if n == name]
            calls = sum(c for c, _ in shapes)
            if calls != counts[name]:
                fail(f"{phase}: {name} launched {counts[name]} times, "
                     f"{calls} calls recorded")
            ms = sum(c * event_ms(lambda: KERNEL[name][0](*args), 10)
                     for c, args in shapes)
            print(f"{phase}: {name} per {label} prove with device "
                  f"Fiat-Shamir: {calls} launches in {len(shapes)} shapes, "
                  f"{ms:.3f} ms summed on the card [{card}]", flush=True)

    def replay_sums(phase, label, calls, counts):
        """Every K11 call of one prove, replayed with its strides against
        field_sum_plain (max abs err 0); printed by (rows, n) bucket, rows
        sums of n terms: calls, the sum of their bounds, and that sum with
        one launch a call."""
        if len(calls) != counts["field_sum"]:
            fail(f"{phase}: field_sum launched {counts['field_sum']} times, "
                 f"{len(calls)} calls recorded")
        buckets, err = {}, 0
        for args in calls:
            _, a, axis = args
            got, want = fk.field_sum(*args), fk.field_sum_plain(*args)
            torch.cuda.synchronize()
            err = max(err, int((got.long() - want.long()).abs().max()))
            if err or got.shape != want.shape:
                fail(f"{phase}: field_sum at {list(a.shape)} strides "
                     f"{list(a.stride())} along {axis}: kernel and plain "
                     f"version differ (max abs err {err})")
            rec = buckets.setdefault(sum_shape(a, axis), [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += least_ms("field_sum", args)
            rec[2] += least_ms("field_sum", args, launch["ms"])
        print(f"{phase}: every field_sum (K11) call of the {label} prove "
              f"({len(calls)}) replayed against field_sum_plain: max abs err "
              f"{err}; by (rows, n): " + json.dumps([
                  {"rows": r, "n": n, "calls": c, "bound_ms": round(b, 4),
                   "bound_launch_ms": round(bl, 4)}
                  for (r, n), (c, b, bl) in sorted(buckets.items())]),
              flush=True)

    histories = {}              # each VM path's transcript, by label
    bound_sums_by_path = {}     # phase 8's bound sums, by label

    def vm_path(phase, label, vm, program, want_steps, want_T,
                by_batch=False, spans=False, host_fs=False, **trace_args):
        """Trace, set up, one prove (recorded, timed, then replayed),
        accept, tamper, timed verify; returns the launch counts of the
        main path (setup + the prove) and of the prove, and the program's
        I/O.  With `spans`, the prove runs with the profiling spans on:
        their table is printed, and each of PROVE_SPANS must fire once and
        together cover SPAN_COVER of the prove's seconds, and the chained
        grand products' spans must be there.  With `host_fs`, a second
        prove follows with JOLT_TPU_DEVICE_FS=0 (spans as the first), whose
        state_history must equal the first prove's."""
        t0 = time.perf_counter()
        steps, io, rows = trace_program(program, vm, **trace_args)
        trace_s = time.perf_counter() - t0
        T = 1 << (len(steps) - 1).bit_length()
        if (len(steps), T) != (want_steps, want_T):
            fail(f"{label} traced to {len(steps)} steps, padded to {T}, not "
                 f"{want_steps} and {want_T}")
        print(f"{phase}: {label} traced to {len(steps)} steps ({len(rows)} "
              f"bytecode rows) in {trace_s:.2f} s, padded to T = 2^"
              f"{T.bit_length() - 1}", flush=True)
        fs_calls = {} if host_fs else None
        bound_sums = {} if host_fs else None
        sum_calls = [] if host_fs else None
        largest = start_recording(by_batch, fs_calls, bound_sums, sum_calls)
        nat.reset_launch_counts()
        t0 = time.perf_counter()
        srs_len = vm.required_srs_len(io, steps, rows)
        pcs_v = HyperKZG.setup(srs_len, device=dev)
        pre_v = vm.preprocess(rows, pcs_v)
        torch.cuda.synchronize()
        setup_v = time.perf_counter() - t0
        setup_counts = nat.launch_counts()
        if fs_calls:
            fs_calls.clear()            # the prove's calls alone
        if bound_sums:
            bound_sums.clear()
        if sum_calls:
            sum_calls.clear()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset()
        profiling.enable(spans)
        t0 = time.perf_counter()
        proof, com, tr, acc = vm.prove(io, steps, pre_v)
        torch.cuda.synchronize()
        prove_v = time.perf_counter() - t0
        profiling.enable(False)
        histories[label] = tr.state_history
        if spans:
            span_check(phase, label, prove_v, CHAIN_SPANS)
        peak, held = torch.cuda.max_memory_allocated() / 1e9, held_gb(largest)
        counts = nat.launch_counts()
        stop_recording()
        prove_counts = {k: v - setup_counts[k] for k, v in counts.items()}
        print(f"{phase}: HyperKZG setup ({srs_len} points) + preprocessing "
              f"{setup_v:.3f} s; main-path launches (setup + the prove) "
              f"{json.dumps(counts)}", flush=True)
        if bound_sums is not None:
            print(f"{phase}: each kernel's calls in the {label} prove, the "
                  f"sum of their bounds (the larger of bytes, operations "
                  f"and, for K8, K9 and the round, the work's dependent "
                  f"chain, per call) and that sum with one launch "
                  f"({launch['ms']:.4f} ms) a call " + json.dumps({
                      name: {"calls": c, "bound_ms": round(b, 4),
                             "bound_us_per_call": round(1e3 * b / c, 4),
                             "bound_launch_ms": round(bl, 4)}
                      for name, (c, b, bl) in bound_sums.items()}),
                  flush=True)
            bound_sums_by_path[label] = dict(bound_sums)
        if sum_calls is not None:
            replay_sums(phase, label, sum_calls, prove_counts)
            sum_calls.clear()
        check_and_replay(phase, label, counts, largest)
        if fs_calls is not None:
            fs_device_ms(phase, label, fs_calls, prove_counts)
        t0 = time.perf_counter()
        vm.verify(pre_v, proof, com, debug_transcript=tr,
                  debug_accumulator=acc)
        print(f"{phase}: verifier accepts ({time.perf_counter() - t0:.3f} "
              f"s, with the debug oracles)", flush=True)
        ops = proof.instruction_lookups.primary_sumcheck.openings
        good = ops.lookup_outputs_opening
        ops.lookup_outputs_opening = good + FElt(1, FR)
        try:
            vm.verify(pre_v, proof, com)
        except VerificationError as e:
            print(f"{phase}: a proof with its lookup-outputs opening bumped "
                  f"by one is rejected ({e})", flush=True)
        else:
            fail(f"{label}: a proof with an opening bumped by one verified")
        ops.lookup_outputs_opening = good
        t0 = time.perf_counter()
        vm.verify(pre_v, proof, com)
        verify_v = time.perf_counter() - t0
        if host_fs:
            os.environ["JOLT_TPU_DEVICE_FS"] = "0"
            nat.reset_launch_counts()
            profiling.reset()
            profiling.enable(spans)
            try:
                t0 = time.perf_counter()
                _, _, tr_h, _ = vm.prove(io, steps, pre_v)
                torch.cuda.synchronize()
                prove_h = time.perf_counter() - t0
            finally:
                profiling.enable(False)
                del os.environ["JOLT_TPU_DEVICE_FS"]
            counts_h = nat.launch_counts()
            if spans:
                span_check(phase, f"{label} JOLT_TPU_DEVICE_FS=0", prove_h,
                           ("BatchedDenseGP::layer",))
            if tr_h.state_history != tr.state_history:
                fail(f"{label}: the JOLT_TPU_DEVICE_FS=0 prove's transcript "
                     "differs from the device Fiat-Shamir prove's")
            if any(counts_h[k] for k in FS_KERNELS):
                fail(f"{label}: the JOLT_TPU_DEVICE_FS=0 prove launched "
                     f"{FS_KERNELS}")
            print(f"{phase}: {label} with device Fiat-Shamir and the chain "
                  f"(the default): prove_s={prove_v:.3f}; with "
                  f"JOLT_TPU_DEVICE_FS=0: prove_s={prove_h:.3f}; the two "
                  f"state_histories equal, event for event "
                  f"({len(tr.state_history)} states) [{card}]", flush=True)
            print(f"{phase}: launches of the JOLT_TPU_DEVICE_FS=0 prove "
                  f"{json.dumps(counts_h)}", flush=True)
            del tr_h
        print(f"{phase}: Jolt VM {label} T=2^{T.bit_length() - 1} C=4 "
              f"M=2^{vm.M.bit_length() - 1} HyperKZG: prove_s={prove_v:.3f} "
              f"verify_s={verify_v:.3f} peak_mem_GB={peak:.2f} (of which "
              f"{held:.2f} GB the recorded calls' copies) [{card}]",
              flush=True)
        print(f"{phase}: launches per {label} prove "
              f"{json.dumps(prove_counts)}", flush=True)
        del proof, com, tr, acc, pre_v, pcs_v
        torch.cuda.empty_cache()
        return counts, prove_counts, io

    def span_check(phase, label, prove_s, need=()):
        """Print the span table of one prove, and fail unless each of
        PROVE_SPANS fired once, they cover SPAN_COVER of its seconds, and
        each span of `need` fired."""
        rows = {name: (calls, secs, ops)
                for name, calls, secs, ops in profiling.cumulative()}
        print(f"{phase}: the span table of the {label} prove [{card}]:",
              flush=True)
        profiling.print_cumulative()
        once = [n for n in PROVE_SPANS if rows.get(n, (0,))[0] != 1]
        if once:
            fail(f"{phase}: prove spans that did not fire exactly once: "
                 f"{once}")
        top = sum(rows[n][1] for n in PROVE_SPANS)
        share = top / prove_s
        print(f"{phase}: prove_s={prove_s:.3f}; the {len(PROVE_SPANS)} "
              f"top-level prove spans sum to {top:.3f} s = {100 * share:.2f} "
              f"% of it; shares: " + ", ".join(
                  f"{n} {100 * rows[n][1] / prove_s:.2f} %"
                  for n in sorted(rows, key=lambda n: -rows[n][1])),
              flush=True)
        if not SPAN_COVER[0] <= share <= SPAN_COVER[1]:
            fail(f"{phase}: the top-level prove spans cover "
                 f"{100 * share:.2f} % of the prove, outside "
                 f"{SPAN_COVER}")
        absent = [n for n in need if rows.get(n, (0,))[0] < 1]
        if absent:
            fail(f"{phase}: {label}: spans that did not fire: {absent}")

    # -- phase 6: the mini VM, fibonacci at T = 2^14 ----------------------
    fib_counts, fib_prove_counts, _ = vm_path(
        "phase 6", f"fib({FIB_N})", cli.fib_vm(FIB_M),
        fibonacci_program(FIB_N), FIB_STEPS, FIB_T, max_input_size=32,
        max_output_size=32)

    phase_done("phase 6")

    # -- phase 7: fib(3) on the card, on the CPU, and jolt_tpu's ----------
    with np.load(ROOT / "fixtures" / "port" / "fib3_hyperkzg.npz") as z:
        frozen = [bytes(row) for row in z["state_history"]]
    vm3 = cli.fib_vm(1 << 8)
    steps3, io3, rows3 = trace_program(fibonacci_program(3), vm3,
                                       max_input_size=32, max_output_size=32)
    hist = {}
    for d in (dev, torch.device("cpu")):
        t0 = time.perf_counter()
        pcs3 = HyperKZG.setup(1 << 8, device=d)
        pre3 = vm3.preprocess(rows3, pcs3)
        p3, c3, t3, _ = vm3.prove(io3, steps3, pre3)
        vm3.verify(pre3, p3, c3, debug_transcript=t3)
        hist[d.type] = t3.state_history
        print(f"phase 7: fib(3) M=2^8 HyperKZG on {d.type}: "
              f"{len(t3.state_history)} transcript states, proved and "
              f"verified in {time.perf_counter() - t0:.2f} s", flush=True)
    if hist["cuda"] != hist["cpu"]:
        fail("fib(3): card and CPU transcripts differ")
    if hist["cuda"] != frozen:
        fail("fib(3): the transcript differs from jolt_tpu's "
             "(fixtures/port/fib3_hyperkzg.npz)")
    print("phase 7: fib(3) card == CPU == jolt_tpu transcript "
          f"({len(frozen)} states)", flush=True)

    phase_done("phase 7")

    # -- phase 8: the full RV32I VM, sha2-chain(13) at T = 2^16 ----------
    sha2_counts, sha2_prove_counts, io8 = vm_path(
        "phase 8", f"sha2-chain({SHA2_ITERS})", rv32i_vm(),
        sha2_chain_program(SHA2_ITERS), SHA2_STEPS, SHA2_T, by_batch=True,
        spans=True, host_fs=True, inputs=cli.SHA2_INPUT)
    print(f"phase 8: the sha2-chain({SHA2_ITERS}) prove's launches: K1 "
          f"(mont_mul) {sha2_prove_counts['mont_mul']}, K10 (field_addsub) "
          f"{sha2_prove_counts['field_addsub']}, K11 (field_sum) "
          f"{sha2_prove_counts['field_sum']}, the primary round "
          f"{sha2_prove_counts['primary_round']}, " + ", ".join(
              f"{k} {sha2_prove_counts[k]}" for k in SUMCHECK_KERNELS)
          + f"; all kernels {sum(sha2_prove_counts.values())} (before the "
          f"toggle and reduction rounds were kernels: {LAUNCHES_BEFORE}) "
          f"[{card}]", flush=True)
    out8 = bytes(io8.outputs)[:32]
    if out8 != sha2_chain_expected(cli.SHA2_INPUT, SHA2_ITERS):
        fail(f"sha2-chain({SHA2_ITERS}): the guest's output {out8.hex()} is "
             "not hashlib's")
    print(f"phase 8: sha2-chain({SHA2_ITERS}) output {out8.hex()} == "
          f"hashlib.sha256 iterated {SHA2_ITERS} times", flush=True)

    phase_done("phase 8")

    # -- phase 9: rv32i_vm() at M = 2^16 against jolt_tpu's frozen proofs
    vm9 = rv32i_vm()
    for case in fx.RV32I_CASES:
        with np.load(ROOT / "fixtures" / "port" / f"{case}.npz") as z:
            want9 = {k: z[k] for k in z.files}
        t0 = time.perf_counter()
        program9, inputs9 = fx.case_program(case)
        steps9, io9, rows9 = trace_program(program9, vm9, inputs=inputs9)
        pre9 = vm9.preprocess(rows9, MockCommitmentScheme(), device=dev)
        _, c9, t9, _ = vm9.prove(io9, steps9, pre9)
        got9 = fx.proof_arrays(t9, c9, digest=True)
        bad9 = fx.differing(got9, want9)
        if bad9:
            fail(f"{case}: {bad9} differ from jolt_tpu's "
                 f"(fixtures/port/{case}.npz)")
        print(f"phase 9: {case} ({len(steps9)} steps) M=2^16 on the card: "
              f"{len(t9.state_history)} transcript states and "
              f"{len(got9['rw_lens']) + len(got9['if_lens'])} commitments "
              f"== jolt_tpu's ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        del pre9, c9, t9
    for case in fx.RV32I_HYPERKZG_CASES:
        with np.load(ROOT / "fixtures" / "port" / f"{case}.npz") as z:
            want9 = {k: z[k] for k in z.files}
        t0 = time.perf_counter()
        program9, inputs9 = fx.case_program(case)
        steps9, io9, rows9 = trace_program(program9, vm9, inputs=inputs9)
        pcs9 = HyperKZG.setup(vm9.required_srs_len(io9, steps9, rows9),
                              device=dev)
        pre9 = vm9.preprocess(rows9, pcs9)
        p9, c9, t9, _ = vm9.prove(io9, steps9, pre9)
        ark9 = jolt_proof_bytes(vm9, pre9, p9, c9)
        got9 = fx.proof_arrays(t9, c9, digest=True, ark=ark9)
        bad9 = fx.differing(got9, want9)
        if bad9:
            fail(f"{case}: {bad9} differ from jolt_tpu's "
                 f"(fixtures/port/{case}.npz)")
        print(f"phase 9: {case} ({len(steps9)} steps) M=2^16 HyperKZG "
              f"({pcs9.pk.n} points) on the card: {len(t9.state_history)} "
              f"transcript states, "
              f"{len(c9['read_write']) + len(c9['init_final'])} commitment "
              f"digests and the {len(ark9)} arkworks proof bytes' SHA-256 "
              f"== jolt_tpu's ({time.perf_counter() - t0:.2f} s)",
              flush=True)
        del pre9, pcs9, p9, c9, t9
    torch.cuda.empty_cache()

    phase_done("phase 9")

    # -- phase 10: the user's path: ELF bytes -> SDK -> proof bytes -------
    with tempfile.TemporaryDirectory() as td:
        elf_path = Path(td) / f"sha3_chain_{SHA3_ITERS}.elf"
        write_elf(str(elf_path), sha3_chain_program(SHA3_ITERS))
        elf = elf_path.read_bytes()
    label10 = f"sha3-chain({SHA3_ITERS})"
    print(f"phase 10: sha3_chain_program({SHA3_ITERS}) written to an ELF "
          f"file of {len(elf)} bytes", flush=True)
    largest10 = start_recording(by_batch=True)
    nat.reset_launch_counts()
    prove10, verify10 = sdk.build_provable(elf, pcs="hyperkzg", device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out10, art10 = prove10(cli.SHA2_INPUT)
    torch.cuda.synchronize()
    prove10_s = time.perf_counter() - t0
    peak10, held10 = (torch.cuda.max_memory_allocated() / 1e9,
                      held_gb(largest10))
    sha3_counts = nat.launch_counts()
    stop_recording()
    T10 = 1 << (art10.trace_length - 1).bit_length()
    if (art10.trace_length, T10) != (SHA3_STEPS, SHA3_T):
        fail(f"{label10} traced to {art10.trace_length} steps, padded to "
             f"{T10}, not {SHA3_STEPS} and {SHA3_T}")
    print(f"phase 10: build_provable(ELF bytes) and its first prove "
          f"(native trace to {art10.trace_length} steps, T = 2^"
          f"{T10.bit_length() - 1}, SRS and preprocessing, prove); "
          f"main-path launches {json.dumps(sha3_counts)}", flush=True)
    check_and_replay("phase 10", label10, sha3_counts, largest10)
    del largest10
    if out10[:32] != sha3_chain_expected(cli.SHA2_INPUT, SHA3_ITERS):
        fail(f"{label10}: the guest's output {out10[:32].hex()} is not "
             "hashlib's")
    print(f"phase 10: {label10} output {out10[:32].hex()} == "
          f"hashlib.sha3_256 iterated {SHA3_ITERS} times", flush=True)
    ark10 = sdk.ark_proof_bytes(art10)
    m10 = len(art10.proof.instruction_lookups.primary_sumcheck.openings
              .E_poly_openings)
    vm10 = rv32i_vm()
    st10 = deserialize_jolt_proof_structure(
        ark10, vm10.C, m10, len(vm10.instruction_classes))
    if (st10["trace_length"], st10["outputs"]) != \
            (art10.trace_length, bytes(art10.proof.program_io.outputs)) \
            or not 0 < st10["_proof_end"] < len(ark10):
        fail(f"{label10}: the arkworks bytes do not read back")
    canon10 = sdk.proof_to_bytes(art10)
    back10 = sdk.proof_from_bytes(canon10)
    if sdk.proof_to_bytes(back10) != canon10:
        fail(f"{label10}: the canonical bytes do not read back identically")
    t0 = time.perf_counter()
    verify10(back10)
    print(f"phase 10: proof_size_bytes={len(ark10)} (arkworks "
          f"JoltHyperKZGProof, re-read by the structure reader); canonical "
          f"{len(canon10)} bytes read back; the proof read back verifies "
          f"({time.perf_counter() - t0:.3f} s)", flush=True)
    ops10 = back10.proof.instruction_lookups.primary_sumcheck.openings
    ops10.lookup_outputs_opening = ops10.lookup_outputs_opening + FElt(1, FR)
    try:
        verify10(back10)
    except VerificationError as e:
        print(f"phase 10: the proof read back with its lookup-outputs "
              f"opening bumped by one is rejected ({e})", flush=True)
    else:
        fail(f"{label10}: a proof with an opening bumped by one verified")
    del back10
    t0 = time.perf_counter()
    verify10(art10)
    verify10_s = time.perf_counter() - t0
    sha3_prove_counts = sha3_counts     # the SDK sets up inside its prove
    print(f"phase 10: SDK {label10} T=2^{T10.bit_length() - 1} C=4 M=2^16 "
          f"HyperKZG: prove_s={prove10_s:.3f} (native trace, SRS and "
          f"preprocessing included) verify_s={verify10_s:.3f} "
          f"peak_mem_GB={peak10:.2f} (of which {held10:.2f} GB the recorded "
          f"calls' copies) [{card}]", flush=True)
    print(f"phase 10: launches per {label10} prove "
          f"{json.dumps(sha3_prove_counts)}", flush=True)
    del prove10, verify10, art10
    torch.cuda.empty_cache()

    phase_done("phase 10")

    # -- phase 11: the commitment schemes at 2^20 -------------------------
    n11 = 1 << PCS_LOGN

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def opening(poly, point):
        return FElt(fd.to_int(FR, mle.evaluate_device(
            FR, poly, mle.eq_evals_device(FR, point, dev))), FR)

    poly11 = cli.pcs_poly(n11, dev)
    rnd11 = random.Random(11)
    point11 = [FElt(rnd11.randrange(FR.p), FR) for _ in range(PCS_LOGN)]
    y11 = opening(poly11, point11)
    pcs_rows = {}

    def scheme11(name, setup, tamper):
        """Set up, commit the pcs-bench polynomial cold and warm, open it at
        point11, verify, and refuse tamper(proof) = (proof', opening')."""
        before = nat.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        pcs11, setup_s = timed(setup)
        _, cold = timed(lambda: pcs11.commit(poly11))
        com, warm = timed(lambda: pcs11.commit(poly11))
        label = name.encode()
        proof, open_s = timed(lambda: pcs11.prove(poly11, point11,
                                                  Transcript(label)))
        _, verify_s = timed(lambda: pcs11.verify(
            proof, Transcript(label), point11, y11, com))
        bad_proof, bad_y = tamper(proof)
        try:
            pcs11.verify(bad_proof, Transcript(label), point11, bad_y, com)
        except VerificationError:
            pass
        else:
            fail(f"{name}: a tampered opening verified")
        row = dict(setup_s=setup_s, commit_cold_s=cold, commit_warm_s=warm,
                   open_s=open_s, verify_s=verify_s,
                   peak_mem_GB=torch.cuda.max_memory_allocated() / 1e9,
                   launches={k: v - before[k] for k, v in
                             nat.launch_counts().items()})
        pcs_rows[name] = row
        print(f"phase 11: {name} 2^{PCS_LOGN}: {json.dumps(row)}; the "
              f"tampered opening is refused [{card}]", flush=True)
        return pcs11, com

    nat.reset_launch_counts()
    bump = lambda proof: (proof, y11 + FElt(1, FR))
    # HyperKZG over phase 3's 2^20-point SRS, still held, and Zeromorph:
    # their largest K1, K5 (and Zeromorph's SRS K6) calls replayed
    largest11 = start_recording(by_batch=False)
    scheme11("hyperkzg", lambda: pcs, bump)
    zm11, _ = scheme11("zeromorph", lambda: Zeromorph.setup(n11, device=dev),
                       bump)
    stop_recording()
    check_and_replay("phase 11", "kzg", nat.launch_counts(), largest11,
                     KZG_KERNELS)
    got = [p.to_affine() for p in cd.jacobian_to_host(
        *(t[:, :1 << 10] for t in zm11.pk.g1_jac))]
    if got != [p for f in host_checks["srs"] for p in f.result()]:
        fail("Zeromorph: the first 2^10 SRS points are not g * tau^i")
    print(f"phase 11: Zeromorph SRS ({zm11.pk.n} points, seed 0x5A4D): its "
          "first 2^10 points == host g * tau^i", flush=True)
    del zm11
    largest11 = start_recording(by_batch=False)
    hx11, _ = scheme11("hyrax", lambda: HyraxScheme.setup(n11, device=dev),
                       lambda proof: (HyraxOpeningProof(
                           [proof.vector_matrix_product[0] + FElt(1, FR)]
                           + proof.vector_matrix_product[1:]), y11))
    stop_recording()
    hyrax_counts = pcs_rows["hyrax"]["launches"]
    check_and_replay("phase 11", "hyrax", hyrax_counts, largest11,
                     HYRAX_KERNELS)
    del largest11
    if hx11.gens.points != [p for f in host_checks["gens"]
                            for p in f.result()]:
        fail("Hyrax: the generators differ from the host's g * k")
    _HOST_POOL.shutdown()
    _HOST_POOL = None
    print(f"phase 11: {len(hx11.gens.points)} Hyrax generators == host "
          "g * k (k from random.Random(b'Jolt v1 Hyrax generators'))",
          flush=True)
    # four polynomials opened together, at 2^16: the host verifier's RLC
    # of the row commitments costs 4 scalar multiplications per row
    nb = 1 << 16
    before_b = nat.launch_counts()
    polys_b = [cli.pcs_poly(nb, dev, seed) for seed in range(4)]
    point_b = point11[:16]
    openings_b = [opening(p, point_b) for p in polys_b]
    coms_b = hx11.batch_commit(polys_b)
    proof_b = hx11.prove_batched(polys_b, point_b, openings_b,
                                 Transcript(b"hxb"), BatchType.SMALL)
    proof_b.verify(hx11, point_b, openings_b, coms_b, Transcript(b"hxb"))
    bad_b = [openings_b[0] + FElt(1, FR)] + openings_b[1:]
    try:
        proof_b.verify(hx11, point_b, bad_b, coms_b, Transcript(b"hxb"))
    except VerificationError:
        pass
    else:
        fail("BatchedHyraxOpeningProof: a tampered opening verified")
    print("phase 11: BatchedHyraxOpeningProof of four 2^16 polynomials "
          "verifies, and is refused with one opening bumped by one",
          flush=True)
    # the path's launches: each scheme's run and the batched proof, not the
    # replays against the plain versions between them
    pcs_counts = {k: v - before_b[k] + sum(r["launches"][k]
                                           for r in pcs_rows.values())
                  for k, v in nat.launch_counts().items()}
    missing = [k for k in PCS_KERNELS if pcs_counts[k] <= 0]
    if missing:
        fail(f"kernels of the commitment schemes' path never launched: "
             f"{missing}")
    print(f"phase 11: launches of the commitment schemes' path "
          f"{json.dumps(pcs_counts)}", flush=True)
    del hx11, polys_b, coms_b, proof_b
    torch.cuda.empty_cache()

    # reference: 2^10 commitments on the card and the CPU, two against the
    # host MSM; jolt_tpu's frozen openings (transcripts, commitments,
    # proofs) reproduced on the card
    t0 = time.perf_counter()
    poly10 = cli.pcs_poly(1 << 10, dev)
    coms10 = {}
    for name, cls in cli.PCS.items():
        pair = []
        for d in (dev, torch.device("cpu")):
            c = cls.setup(1 << 10, device=d).commit(poly10.to(d))
            pair.append(c.row_commitments if name == "hyrax" else [c.point])
        if pair[0] != pair[1]:
            fail(f"{name} 2^10: card and CPU commitments differ")
        coms10[name] = pair[0]
    scal10 = [int(v) for v in fd.device_to_ints(FR, poly10)]
    srs10 = [G1Jacobian(int(a), int(b), int(c)).to_affine()
             for a, b, c in zip(*(fd.unpack_ints(fd.from_mont_device(
                 FQ, torch.from_numpy(fix[k][:, :1 << 10].astype(np.int32))))
                 for k in ("X", "Y", "Z")))]
    gens10 = HyraxScheme.setup(1 << 10, device=dev).gens.points
    if coms10["hyperkzg"][0] != g1_msm_host(srs10, scal10):
        fail("HyperKZG 2^10: the commitment differs from the host MSM")
    if coms10["hyrax"][0] != g1_msm_host(gens10, scal10[:len(gens10)]):
        fail("Hyrax 2^10: row 0 differs from the host MSM")
    got11 = pfx.prove_port_cases(dev)
    for case in ("zeromorph_l6", "hyrax_l7"):
        with np.load(ROOT / "fixtures" / "port" / f"{case}.npz") as z:
            bad = [k for k in z.files if not np.array_equal(z[k], got11[k])]
        if bad:
            fail(f"{case}: {bad} differ from jolt_tpu's "
                 f"(fixtures/port/{case}.npz)")
    print(f"phase 11: 2^10 commitments card == CPU for "
          f"{', '.join(cli.PCS)}; HyperKZG's and Hyrax's row 0 == host MSM; "
          f"jolt_tpu's frozen Zeromorph (ell = 3, 6) and Hyrax (ell = 3, 6, "
          f"7; ratio 1, 4; batched x 4) openings reproduced on the card: "
          f"{len(got11)} arrays ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    phase_done("phase 11")

    # -- phase 12: the Quarks hybrid grand product at full size -----------
    # B = 16 circuits of 2^20 leaves (one batch of memory-checking
    # fingerprints of a 2^20-step trace): four dense GKR base layers
    # (2^20 -> 2^17 leaves) and a quark top over 2^16 (16 sumcheck rounds,
    # 2B + 3 = 35 polynomials in the comb); HyperKZG over the 2^16-point
    # SRS fixture, whose 16 g commitments take the GRAND_PRODUCT batch
    # (g_products: K6 in 16 levels from 2^15 lanes)
    vals12 = np.random.default_rng(12).integers(
        1, 1 << 63, size=(QUARK_B, 1 << QUARK_LOGN), dtype=np.uint64)
    largest12 = start_recording(by_batch=False)
    nat.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    leaves12 = fd.u64_to_mont_device(FR, vals12, dev)
    pcs12 = HyperKZG.setup(QUARK_SRS, device=dev)
    gp12 = QuarkGrandProduct.construct(leaves12, FR)
    claims12 = gp12.claims()
    t12 = Transcript(b"quark")
    pacc12 = ProverOpeningAccumulator(FR)
    proof12, _ = gp12.prove_grand_product(pacc12, t12, pcs12)
    reduced12 = pacc12.reduce_and_prove(pcs12, t12)
    torch.cuda.synchronize()
    prove12_s = time.perf_counter() - t0
    peak12, held12 = (torch.cuda.max_memory_allocated() / 1e9,
                      held_gb(largest12))
    quark_counts = nat.launch_counts()
    stop_recording()
    del gp12
    print(f"phase 12: Quarks hybrid B={QUARK_B} n=2^{QUARK_LOGN}: "
          f"{len(proof12.layers)} GKR base layers, quark top of "
          f"{proof12.quark.num_vars} sumcheck rounds; main-path launches "
          f"{json.dumps(quark_counts)}", flush=True)
    check_and_replay("phase 12", "quark", quark_counts, largest12,
                     QUARK_KERNELS)
    del largest12

    def verify12(proof):
        vt = Transcript(b"quark")
        vacc = VerifierOpeningAccumulator(pcs12, FR)
        QuarkGrandProduct.verify_grand_product(proof, claims12, vacc, vt, FR)
        vacc.reduce_and_verify(pcs12, reduced12, vt)

    t0 = time.perf_counter()
    verify12(proof12)
    verify12_s = time.perf_counter() - t0
    w12 = ser.Writer()
    ser.serialize_grand_product(w12, proof12)
    bytes12 = w12.getvalue()
    back12 = ser.deserialize_grand_product(ser.Reader(bytes12))
    w12 = ser.Writer()
    ser.serialize_grand_product(w12, back12)
    if w12.getvalue() != bytes12:
        fail("phase 12: the grand-product bytes do not read back "
             "identically")
    verify12(back12)
    hv = back12.quark.helper_values[0]
    hv[0] = hv[0] + FElt(1, FR)
    try:
        verify12(back12)
    except VerificationError:
        pass
    else:
        fail("phase 12: a quark proof with a helper value bumped by one "
             "verified")
    dense12 = BatchedDenseGrandProduct.construct(leaves12, FR).claims()
    if [c.v for c in dense12] != [c.v for c in claims12]:
        fail("phase 12: the hybrid's claims differ from the dense grand "
             "product's")
    del back12, dense12, leaves12, pcs12
    torch.cuda.empty_cache()
    print(f"phase 12: Quarks hybrid B={QUARK_B} n=2^{QUARK_LOGN} HyperKZG "
          f"({QUARK_SRS} points): prove_s={prove12_s:.3f} (leaves to the "
          f"card, setup, construct, claims, prove, opening reduction) "
          f"verify_s={verify12_s:.3f} peak_mem_GB={peak12:.2f} (of which "
          f"{held12:.2f} GB the recorded calls' copies); claims == the dense "
          f"GKR's; {len(bytes12)} canonical bytes read back, verified, and "
          f"refused with a helper value bumped by one [{card}]", flush=True)

    # the reference bench's shape (benches/commit.rs:11-60): 2^20
    # coefficients, 90 % of them one, the rest uniform field elements from
    # default_rng(13), committed with phase 3's 2^20-point SRS through
    # GRAND_PRODUCT and through BIG
    ng = 1 << GP_COMMIT_LOGN
    rng13 = np.random.default_rng(13)
    ones13 = rng13.random(ng) < 0.9
    limbs13 = rng13.integers(0, 1 << 16, size=(16, ng), dtype=np.int64)
    limbs13[15] = rng13.integers(0, int(FR.p_limbs[15]), size=ng)
    limbs13[:, ones13] = 0
    limbs13[0, ones13] = 1
    poly13 = fd.to_mont_device(
        FR, torch.from_numpy(limbs13.astype(np.int32)).to(dev))
    largest13 = start_recording(by_batch=False)
    nat.reset_launch_counts()
    gprod13, gprod13_s = timed(pcs.pk.g_products)
    gprod_counts = nat.launch_counts()
    pcs.batch_commit([poly13], BatchType.GRAND_PRODUCT)        # warm-up
    com_gp, gp13_s = timed(lambda: pcs.batch_commit(
        [poly13], BatchType.GRAND_PRODUCT)[0])
    pcs.batch_commit([poly13], BatchType.BIG)
    com_big, big13_s = timed(lambda: pcs.batch_commit(
        [poly13], BatchType.BIG)[0])
    gpc_counts = nat.launch_counts()
    stop_recording()
    if com_gp != com_big:
        fail("phase 12: the GRAND_PRODUCT and BIG commitments of the "
             "90 %-ones polynomial differ")
    if len(gprod13) != GP_COMMIT_LOGN + 1 or gprod_counts["jac_add"] != \
            GP_COMMIT_LOGN:
        fail(f"phase 12: g_products took {gprod_counts['jac_add']} K6 "
             f"launches for {len(gprod13)} sums, not {GP_COMMIT_LOGN}")
    print(f"phase 12: 90 %-ones 2^{GP_COMMIT_LOGN} commit ({int(ones13.sum())} "
          f"ones): g_products first build {gprod13_s:.4f} s "
          f"({gprod_counts['jac_add']} K6 levels from 2^{GP_COMMIT_LOGN - 1} "
          f"lanes); warm commit GRAND_PRODUCT {gp13_s:.4f} s, BIG "
          f"{big13_s:.4f} s; the two points are equal; launches "
          f"{json.dumps(gpc_counts)} [{card}]", flush=True)
    check_and_replay("phase 12", "GP commit", gpc_counts, largest13,
                     GP_COMMIT_KERNELS)
    del largest13, poly13, limbs13

    phase_done("phase 12")

    # -- phase 13: the EVM verifier path ----------------------------------
    nat.reset_launch_counts()
    t0 = time.perf_counter()
    evm_fx = evm_fixtures.generate_all(dev)
    evm_counts = nat.launch_counts()
    gen13_s = time.perf_counter() - t0
    for name, got in evm_fx.items():
        want = json.loads((ROOT / "fixtures" / "evm" / f"{name}.json")
                          .read_text())
        if got != want:
            fail(f"phase 13: the {name} fixture differs from "
                 f"fixtures/evm/{name}.json")
    missing = [k for k in EVM_KERNELS if evm_counts[k] <= 0]
    if missing:
        fail(f"phase 13: kernels of the fixture generators never launched: "
             f"{missing}")
    sol_dir = ROOT / "evm_verifier" / "src" / "subprotocols"
    with tempfile.TemporaryDirectory() as td:
        src13 = gen_r1cs_sol(str(Path(td) / "R1CSMatrix.sol"))
    if src13 != (sol_dir / "R1CSMatrix.sol").read_text():
        fail("phase 13: the generated R1CSMatrix.sol differs from "
             "evm_verifier/src/subprotocols/R1CSMatrix.sol")
    print(f"phase 13: the four EVM fixtures generated on the card in "
          f"{gen13_s:.2f} s == fixtures/evm/*.json; launches "
          f"{json.dumps(evm_counts)}; R1CSMatrix.sol generated == the "
          f"committed file ({len(src13)} bytes)", flush=True)
    t0 = time.perf_counter()
    svm = load_vm(str(sol_dir))
    sol_t = lambda: svm.call("FiatShamirTranscript.newTranscript",
                             b"test_transcript".ljust(32, b"\x00"))
    sumcheck = lambda rounds: svm.make_struct(
        "SumcheckVerifier.SumcheckProof", rounds=[svm.make_struct(
            "SumcheckVerifier.CompressedUniPoly",
            coeffsExceptLinear=[svm.fr(int(c, 16)) for c in r])
            for r in rounds])

    def sol_gp(fx, bump):
        layers = []
        for i, lay in enumerate(fx["layers"]):
            left = [int(c, 16) for c in lay["left_claims"]]
            if bump and i == 1:
                left[0] = (left[0] + 1) % FR.p
            layers.append(svm.make_struct(
                "GrandProductVerifier.LayerProof",
                sumcheck=sumcheck(lay["sumcheck"]),
                leftClaims=[svm.fr(c) for c in left],
                rightClaims=[svm.fr(int(c, 16))
                             for c in lay["right_claims"]]))
        return (svm.make_struct("GrandProductVerifier.GrandProductProof",
                                layers=layers),
                [svm.fr(int(c, 16)) for c in fx["claims"]], sol_t())

    g1p = lambda d: svm.make_struct("HyperKZG.G1Point", x=int(d["x"], 16),
                                    y=int(d["y"], 16))
    g2p = lambda d: svm.make_struct(     # imaginary part first
        "HyperKZG.G2Point", x=[int(d["x"][1], 16), int(d["x"][0], 16)],
        y=[int(d["y"][1], 16), int(d["y"][0], 16)])

    def sol_hyperkzg(fx, bump):
        vk = svm.make_struct("HyperKZG.VerifierKey", g1=g1p(fx["vk"]["g1"]),
                             g2=g2p(fx["vk"]["g2"]),
                             betaG2=g2p(fx["vk"]["beta_g2"]))
        proof = svm.make_struct(
            "HyperKZG.HyperKZGProof",
            com=[g1p(p) for p in fx["proof"]["com"]],
            w=[g1p(p) for p in fx["proof"]["w"]],
            v=[svm.fr(int(x, 16)) for row in fx["proof"]["v"] for x in row])
        y = (int(fx["opening"], 16) + bump) % FR.p
        return (proof, vk, sol_t(), [svm.fr(int(x, 16)) for x in fx["point"]],
                svm.fr(y), g1p(fx["commitment"]))

    def sol_spartan(fx, bump):
        evals = [int(c, 16) for c in fx["claimed_witness_evals"]]
        evals[3] = (evals[3] + bump) % FR.p
        az, bz, cz = (svm.fr(int(c, 16)) for c in fx["outer_claims"])
        proof = svm.make_struct(
            "SpartanVerifier.SpartanProof",
            outer=sumcheck(fx["outer_sumcheck"]), outerClaimAz=az,
            outerClaimBz=bz, outerClaimCz=cz,
            inner=sumcheck(fx["inner_sumcheck"]),
            claimedWitnessEvals=[svm.fr(v) for v in evals])
        return proof, fx["steps_bits"], sol_t()

    for fn, name, build in (
            ("GrandProductVerifier.verify", "grand_product", sol_gp),
            ("HyperKZG.verify", "hyperkzg", sol_hyperkzg),
            ("SpartanVerifier.verifySpartan", "spartan", sol_spartan)):
        out = svm.call(fn, *build(evm_fx[name], 0))
        if name == "grand_product" and [x.val for x in out[1]] != \
                [int(v, 16) for v in evm_fx[name]["r_grand_product"]]:
            fail("phase 13: GrandProductVerifier.sol's point differs from "
                 "the fixture's")
        try:
            svm.call(fn, *build(evm_fx[name], 1))
        except SolidityRevert:
            pass
        else:
            fail(f"phase 13: {fn} accepted a tampered {name} fixture")
    print(f"phase 13: the Solidity VM executes GrandProductVerifier.verify, "
          f"HyperKZG.verify and SpartanVerifier.verifySpartan on the "
          f"generated fixtures: accepted, and reverted on one tampered value "
          f"each ({time.perf_counter() - t0:.2f} s)", flush=True)

    phase_done("phase 13")

    # -- phase 14: the scaffold: cli.py new, then its host.py on the card -
    with tempfile.TemporaryDirectory() as td:
        proj = Path(td) / "fib_project"
        cli.main(["new", str(proj), "--pcs", "hyperkzg"])
        t0 = time.perf_counter()
        run14 = subprocess.run([sys.executable, "-c", SCAFFOLD_RUNNER],
                               cwd=proj, capture_output=True, text=True,
                               env={**os.environ, "PYTHONPATH": str(ROOT)},
                               timeout=300)
        host14_s = time.perf_counter() - t0
    out14 = run14.stdout.splitlines()
    if run14.returncode != 0 or "proof verified" not in out14:
        fail(f"phase 14: the scaffold's host.py failed (rc "
             f"{run14.returncode}): {run14.stdout[-2000:]} "
             f"{run14.stderr[-2000:]}")
    scaffold_counts = json.loads(out14[-1].split(" ", 1)[1])
    missing = [k for k in VM_KERNELS if scaffold_counts.get(k, 0) <= 0]
    if missing:
        fail(f"phase 14: kernels of the scaffold's prove never launched: "
             f"{missing}")
    print(f"phase 14: cli.py new wrote guest.py, host.py, README.md; "
          f"python host.py (HyperKZG, on the card) printed "
          f"{' / '.join(out14[:-1])} in {host14_s:.2f} s (a new process: "
          f"imports, SRS, preprocessing, prove, verify); its launches "
          f"{json.dumps(scaffold_counts)}", flush=True)

    phase_done("phase 14")

    # -- phase 15: the CLI's traced, profiled prove in a child process ----
    with tempfile.TemporaryDirectory() as td:
        cmd15 = [sys.executable, "-m", "jolt_tpu_torch.cli", "--trace", td,
                 *TRACE_CMD]
        t0 = time.perf_counter()
        run15 = subprocess.run(cmd15, cwd=ROOT, capture_output=True,
                               text=True, timeout=600,
                               env={**os.environ, "PYTHONPATH": str(ROOT)})
        child15_s = time.perf_counter() - t0
        if run15.returncode != 0:
            fail(f"phase 15: {' '.join(cmd15[1:])} failed (rc "
                 f"{run15.returncode}): {run15.stdout[-2000:]} "
                 f"{run15.stderr[-2000:]}")
        trace15 = Path(td) / profiling.TRACE_FILE
        size15 = trace15.stat().st_size
        t0 = time.perf_counter()
        try:
            data15 = json.loads(trace15.read_text())
        except ValueError as e:
            fail(f"phase 15: the trace is not JSON: {e}")
        parse15_s = time.perf_counter() - t0
    events15 = data15["traceEvents"] if isinstance(data15, dict) else data15
    del data15
    names15 = {e.get("name") for e in events15}
    cats15 = {}
    for e in events15:
        cats15[e.get("cat")] = cats15.get(e.get("cat"), 0) + 1
    k1_fn = next(k.function for k in nat.KERNELS if k.name == "mont_mul")
    k1_events = sum(1 for e in events15 if e.get("cat") == "kernel"
                    and k1_fn in (e.get("name") or ""))
    del events15
    missing15 = [n for n in TRACE_SPANS if n not in names15]
    if missing15:
        fail(f"phase 15: the trace lacks the spans {missing15}")
    if k1_events < 1:
        fail(f"phase 15: the trace holds no {k1_fn} (K1) kernel event")
    out15 = run15.stdout.splitlines()
    res15 = json.loads(out15[-1])
    print("phase 15: " + " ".join(cmd15[1:4]) + " DIR " + " ".join(TRACE_CMD)
          + f": rc 0 in {child15_s:.2f} s; {res15}", flush=True)
    for line in out15[:-1]:
        print(f"phase 15: | {line}", flush=True)
    print(f"phase 15: the trace: {size15} bytes, JSON parsed in "
          f"{parse15_s:.2f} s; events by category {json.dumps(cats15)}; "
          f"{k1_events} {k1_fn} (K1/K4) kernel events; "
          f"every one of {len(TRACE_SPANS)} span names present", flush=True)

    phase_done("phase 15")

    # -- phase 16: the multi-device prover (parallel/sharding.py) ---------
    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        mesh_a = mesh_c = sh.make_mesh()
        kind16 = f"a real mesh over {n_cards} cards"
    else:
        mesh_a, mesh_c = (sh.make_mesh(k, device=dev) for k in (4, 2))
        kind16 = ("a virtual mesh on cuda:0 (one card: every shard on it, "
                  "each step run once per shard)")
    print(f"phase 16: {kind16}: {mesh_a} for (a) and (b), {mesh_c} for (c)",
          flush=True)
    nat.reset_launch_counts()
    # (a) one GKR round at the full VM's read/write batch: B = 110
    # circuits, s = 2^15 per side, against one unsharded K2 and K3 call
    Ba, sa = 110, 1 << 15
    la = rand_fe(FR, Ba, sa).movedim(0, 1).contiguous()
    ra = rand_fe(FR, Ba, sa).movedim(0, 1).contiguous()
    eqa, coa = rand_fe(FR, sa), rand_fe(FR, Ba)
    rca = fd.scalar_to_device(FR, 0x1234567 ** 9, dev)
    want_e = fk.gp_pair_evals(FR, la, ra, eqa, coa)
    want_b = fk.gp_pair_bind(FR, la, ra, eqa, rca)
    pla, pra = sh.maybe_shard_pair(mesh_a, (la, ra))
    Bp = pla.length
    copad = torch.cat([coa, fd.zeros(FR, (Bp - Ba,), dev)], dim=1)
    before = nat.launch_counts()
    got_a = sh.sharded_gp_round(mesh_a, FR, pla, pra, eqa, copad, rca)
    torch.cuda.synchronize()
    after = nat.launch_counts()
    k23 = {k: after[k] - before[k] for k in GP_KERNELS}
    if k23 != {k: mesh_a.size for k in GP_KERNELS}:
        fail(f"phase 16 (a): K2/K3 launched {k23} times, not once per "
             f"shard ({mesh_a.size})")
    bad_a = [name for name, g, w in (
        ("evals", got_a[0], want_e),
        ("l", got_a[1].gather()[:Ba], want_b[0]),
        ("r", got_a[2].gather()[:Ba], want_b[1]),
        ("eq", got_a[3].gather(), want_b[2])) if not torch.equal(g, w)]
    if bad_a or (got_a[1].gather()[Ba:] != 0).any():
        fail(f"phase 16 (a): the sharded round's {bad_a or 'pad rows'} "
             "differ from the unsharded K2/K3 call's")
    round_ms = event_ms(lambda: sh.sharded_gp_round(
        mesh_a, FR, pla, pra, eqa, copad, rca), 3, hold=False)
    plain_ms = event_ms(lambda: (fk.gp_pair_evals(FR, la, ra, eqa, coa),
                                 fk.gp_pair_bind(FR, la, ra, eqa, rca)), 3,
                        hold=False)
    print(f"phase 16 (a): one GKR round, B = {Ba} padded to {Bp} over "
          f"{mesh_a.size} shards, s = 2^15: evaluations and bound l, r, eq "
          f"== one unsharded K2 + K3 call; K2 and K3 launched once per "
          f"shard; sharded round {round_ms:.3f} ms, unsharded "
          f"{plain_ms:.3f} ms [{card}]", flush=True)
    del la, ra, eqa, want_b, pla, pra, got_a
    # (b) the HyperKZG batch commit at 2^20 (phase 11's polynomial, phase
    # 3's SRS) on the mesh against the unsharded commit; then the window
    # MSM (K6, K7) on 2^10 points against the host MSM
    poly16 = cli.pcs_poly(1 << PCS_LOGN, dev)
    want16 = pcs.batch_commit([poly16])[0].point
    before = nat.launch_counts()
    t0 = time.perf_counter()
    got16 = pcs.batch_commit([poly16], mesh=mesh_a)[0].point
    commit16_s = time.perf_counter() - t0
    after = nat.launch_counts()
    kb = {k: after[k] - before[k] for k in ("proj_cadd", "jac_add")}
    if min(kb.values()) < 1:
        fail(f"phase 16 (b): the sharded commit launched {kb}")
    if got16 != want16:
        fail("phase 16 (b): the sharded 2^20 HyperKZG commitment differs "
             "from the unsharded one")
    n10 = 1 << 10
    jac10 = tuple(t[:, :n10] for t in pcs.pk.g1_jac)
    rng16 = np.random.default_rng(16)
    sc10 = [int(v) for v in rng16.integers(1, 1 << 63, n10)]
    got10 = sh.sharded_msm(mesh_a, jac10, fd.ints_to_device(FR, sc10, dev))
    want10 = g1_msm_host([p.to_affine() for p in cd.jacobian_to_host(*jac10)],
                         sc10)
    if got10 != want10:
        fail("phase 16 (b): sharded_msm over 2^10 points differs from the "
             "host MSM")
    print(f"phase 16 (b): HyperKZG batch commit of the 2^20 pcs-bench "
          f"polynomial on {mesh_a}: == the unsharded commitment "
          f"({commit16_s:.3f} s; K5 and K6 launched {kb}); sharded_msm "
          f"(window MSM: K6 scans, K6 fold, K7 Horner) over 2^10 points "
          f"== the host MSM [{card}]", flush=True)
    del poly16
    # (c) the slice's path at full width: sha2-chain(13) on rv32i_vm() at
    # T = 2^16, HyperKZG, through JoltVM.prove(mesh=), device FS on
    vm16 = rv32i_vm()
    steps16, io16, rows16 = trace_program(
        sha2_chain_program(SHA2_ITERS), vm16, inputs=cli.SHA2_INPUT)
    pcs16 = HyperKZG.setup(vm16.required_srs_len(io16, steps16, rows16),
                           device=dev)
    pre16 = vm16.preprocess(rows16, pcs16)
    torch.cuda.synchronize()
    before = nat.launch_counts()
    t0 = time.perf_counter()
    proof16, com16, tr16, acc16 = vm16.prove(io16, steps16, pre16,
                                             mesh=mesh_c)
    torch.cuda.synchronize()
    prove16_s = time.perf_counter() - t0
    after = nat.launch_counts()
    c16 = {k: after[k] - before[k] for k in after}
    missing = [k for k in MESH_KERNELS if c16[k] <= 0]
    if missing:
        fail(f"phase 16 (c): kernels of the mesh prove never launched: "
             f"{missing}")
    want8 = histories[f"sha2-chain({SHA2_ITERS})"]
    if tr16.state_history != want8:
        fail("phase 16 (c): the mesh prove's transcript differs from phase "
             "8's")
    out16 = bytes(io16.outputs)[:32]
    if out16 != sha2_chain_expected(cli.SHA2_INPUT, SHA2_ITERS):
        fail(f"phase 16 (c): the guest's output {out16.hex()} is not "
             "hashlib's")
    vm16.verify(pre16, proof16, com16, debug_transcript=tr16,
                debug_accumulator=acc16)
    ops16 = proof16.instruction_lookups.primary_sumcheck.openings
    ops16.lookup_outputs_opening = ops16.lookup_outputs_opening + FElt(1, FR)
    try:
        vm16.verify(pre16, proof16, com16)
    except VerificationError as e:
        print(f"phase 16 (c): a proof with its lookup-outputs opening bumped "
              f"by one is rejected ({e})", flush=True)
    else:
        fail("phase 16 (c): a mesh proof with an opening bumped verified")
    mesh_counts = nat.launch_counts()
    print(f"phase 16 (c): sha2-chain({SHA2_ITERS}) on rv32i_vm() T=2^16 "
          f"HyperKZG through JoltVM.prove(mesh={mesh_c}) with device "
          f"Fiat-Shamir: prove_s={prove16_s:.3f}; state_history == phase "
          f"8's ({len(want8)} states); output == hashlib; verified; "
          f"launches of the prove {json.dumps(c16)} [{card}]", flush=True)
    print(f"phase 16: launches of the mesh path (a, b, c) "
          f"{json.dumps(mesh_counts)}", flush=True)
    del proof16, com16, tr16, acc16, pre16, pcs16
    torch.cuda.empty_cache()

    phase_done("phase 16")
    print(f"phase wall seconds {json.dumps(walls)}, total "
          f"{sum(walls.values()):.1f}", flush=True)

    # -- summary ----------------------------------------------------------
    sha2_bounds = bound_sums_by_path[f"sha2-chain({SHA2_ITERS})"]
    kernels = []
    for k in nat.KERNELS:
        r = results[k.name]["phase 2"]
        row = {
            "name": k.name, "route": "cuda", "source": k.source_path,
            "replaces": k.replaces,
            "launches": (sha2_counts if k.name in FIELD_KERNELS
                         else main_counts)[k.name],
            "max_abs_err": max(v["max_abs_err"] for v in
                               [*results[k.name].values(),
                                *more.get(k.name, [])]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "bytes_bound_ms": r["bytes_bound_ms"],
            "ops_bound_ms": r["ops_bound_ms"], "shape": r["shape"],
            "launches_per_prove": prove_counts[k.name],
            "launches_fib_main_path": fib_counts[k.name],
            "launches_per_fib_prove": fib_prove_counts[k.name],
            "launches_sha2_main_path": sha2_counts[k.name],
            "launches_per_sha2_prove": sha2_prove_counts[k.name],
            "launches_sha3_main_path": sha3_counts[k.name],
            "launches_per_sha3_prove": sha3_prove_counts[k.name],
            "launches_pcs_path": pcs_counts[k.name],
            "launches_pcs_by_scheme": {name: r["launches"][k.name]
                                       for name, r in pcs_rows.items()},
            "launches_quark_path": quark_counts[k.name],
            "launches_gp_commit_path": gpc_counts[k.name],
            "launches_evm_fixtures": evm_counts[k.name],
            "launches_scaffold_prove": scaffold_counts.get(k.name, 0),
            "launches_mesh_path": mesh_counts[k.name]}
        calls8, bound8, bound8_l = sha2_bounds.get(k.name, (0, 0.0, 0.0))
        row.update(sha2_prove_calls=calls8, sha2_bound_sum_ms=bound8,
                   sha2_bound_sum_launch_ms=bound8_l)
        for key in ("latency_bound_ms", "serial_latency_bound_ms",
                    "plan_latency_bound_ms", "launch_ms", "host_ms"):
            if key in r:
                row[key] = r[key]
        row.update(usage[k.name])
        if k.name in more:
            row["more_shapes"] = more[k.name]
        for ph, key in ((f"phase 6 fib({FIB_N})", "at_fib_shape"),
                        (f"phase 8 sha2-chain({SHA2_ITERS})",
                         "at_sha2_shape"),
                        (f"phase 10 {label10}", "at_sha3_shape"),
                        ("phase 12 quark", "at_quark_shape"),
                        ("phase 12 GP commit", "at_gp_commit_shape")):
            if ph in results[k.name]:
                row[key] = results[k.name][ph]
        pcs_calls = [results[k.name][ph] for ph in
                     ("phase 11 hyrax", "phase 11 kzg") if ph in
                     results[k.name]]
        if pcs_calls:           # the larger; Hyrax's on a tie (K6)
            row["at_pcs_shape"] = max(pcs_calls, key=lambda r: r["bound_ms"])
        if k.name in OFF_PATH:
            row["off_main_path"] = OFF_PATH[k.name]
        if k.name in FIELD_KERNELS:
            row["launches_path"] = f"phase 8 sha2-chain({SHA2_ITERS})"
        if k.name in OFF_SURGE:
            row["off_surge_path"] = OFF_SURGE[k.name]
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
