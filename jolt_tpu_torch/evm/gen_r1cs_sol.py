"""Generate R1CSMatrix.sol, the Solidity verifier's closed-form R1CS matrix
MLEs, from the port's constraint system (jolt_tpu/evm/gen_r1cs_sol.py).

The reference ships a hand-transcribed, hardcoded R1CSMatrix.sol ("changing
the R1CS in jolt's rust will break this function",
jolt-evm-verifier/src/subprotocols/R1CSMatrix.sol:40) plus an
autogenerate_r1cs.rs fixture script.  Here the Solidity evaluation is
generated from the same `build_jolt_constraints` builder the port's prover
uses (vm/r1cs.py), so it cannot drift from the circuit; its text is
jolt_tpu's generator's, byte for byte, so the output equals the committed
evm_verifier/src/subprotocols/R1CSMatrix.sol.

Mirrors vm/r1cs.py UniformSpartanKey.evaluate_z_mle and
.evaluate_r1cs_matrix_mles (reference key.rs:284-395) and _eq_plus_one
(special_polys.rs:404-426).

    python -m jolt_tpu_torch.evm.gen_r1cs_sol OUT.sol   # writes OUT.sol
    python -m jolt_tpu_torch.evm.gen_r1cs_sol           # prints the source

`generate` returns the source and writes it only where it is told to:
never into evm_verifier/ by default.
"""
from __future__ import annotations

import sys

from ..field.spec import fr_spec
from ..vm import r1cs as r1cs_mod
from ..vm.rv_trace import (DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE,
                           MemoryLayout, RAM_START_ADDRESS)


def _log2_pow2(n: int) -> int:
    k = (n - 1).bit_length()
    return k


def _fr(co: int, p: int) -> str:
    return f"Fr.wrap(0x{co % p:x})"


def _gen_uniform_terms(constraints, matrix_idx: int, p: int) -> list[str]:
    """Straight-line `t`/`ct` accumulation for one of A/B/C."""
    lines = []
    for row, cons in enumerate(constraints):
        lc = cons[matrix_idx]
        for v, co in lc.terms:
            lines.append(
                f"        t = t + {_fr(co, p)} * eqRxConstr[{row}]"
                f" * eqRyVar[{v}];")
        if lc.const:
            lines.append(
                f"        ct = ct + {_fr(lc.const, p)} * eqRxConstr[{row}];")
    return lines


def _gen_non_uniform(non_uniform, num_rows: int, p: int) -> list[str]:
    """A gets the offset-eq (a - b) part, B the condition part
    (key.rs / vm/r1cs.py evaluate_r1cs_matrix_mles non-uniform rows)."""
    lines = []
    for i, oc in enumerate(non_uniform):
        lines.append(f"        // non-uniform row {i}")
        lines.append(f"        rowEq = eqRxConstr[{num_rows + i}];")
        terms_a = ([(v, oc.a[1], co) for v, co in oc.a[0].terms]
                   + [(v, oc.b[1], -co) for v, co in oc.b[0].terms])
        const_a = -oc.b[0].const
        terms_b = [(v, oc.cond[1], co) for v, co in oc.cond[0].terms]
        const_b = oc.cond[0].const
        for dst, terms, const in (("a", terms_a, const_a),
                                  ("b", terms_b, const_b)):
            lines.append("        nu = Fr.wrap(0);")
            for v, is_offset, co in terms:
                e = "eqStepPlusOne" if is_offset else "eqRxRyStep"
                lines.append(
                    f"        nu = nu + {_fr(co, p)} * eqRyVar[{v}] * {e};")
            if const:
                lines.append(
                    f"        nu = nu + {_fr(const, p)} * colEqConstant;")
            lines.append(f"        {dst}Eval = {dst}Eval + nu * rowEq;")
    return lines


HEADER = """\
// SPDX-License-Identifier: MIT
pragma solidity >=0.8.21;

import {{Fr, FrLib, FR_MODULUS}} from "./Fr.sol";

/// Closed-form evaluation of the uniform Jolt RV32I R1CS matrix MLEs and
/// the virtualized witness MLE Z (mirror of vm/r1cs.py UniformSpartanKey
/// .evaluate_z_mle / .evaluate_r1cs_matrix_mles; reference key.rs:284-395).
///
/// AUTO-GENERATED by jolt_tpu/evm/gen_r1cs_sol.py from
/// build_jolt_constraints — do not edit by hand; regenerate instead.
/// Circuit parameters: C={C}, {num_vars} witness columns, {num_rows}
/// uniform rows + {num_nu} offset-eq rows, default memory layout.
library R1CSMatrix {{
    uint256 constant NUM_VARS = {num_vars};
    uint256 constant VAR_BITS = {var_bits};      // log2(next_pow2(NUM_VARS))
    uint256 constant CONSTR_BITS = {constr_bits}; // log2(next_pow2(rows+1))

    /// eq(r, x) table over the 2^len hypercube (doubling DP,
    /// poly/mle.py eq_evals_host).
    function eqEvals(Fr[] memory r, uint256 start, uint256 len)
        internal pure returns (Fr[] memory table)
    {{
        table = new Fr[](1 << len);
        table[0] = Fr.wrap(1);
        uint256 size = 1;
        for (uint256 j = 0; j < len; j++) {{
            for (uint256 i = size; i > 0; i--) {{
                Fr hi = table[i - 1] * r[start + j];
                table[2 * i - 1] = hi;
                table[2 * i - 2] = table[i - 1] - hi;
            }}
            size *= 2;
        }}
    }}

    /// eq(x, y) = prod_i (x_i y_i + (1-x_i)(1-y_i)).
    function eqEvaluate(Fr[] memory x, uint256 xs, Fr[] memory y, uint256 ys,
                        uint256 len) internal pure returns (Fr out)
    {{
        out = Fr.wrap(1);
        Fr one = Fr.wrap(1);
        for (uint256 i = 0; i < len; i++) {{
            out = out * (x[xs + i] * y[ys + i]
                         + (one - x[xs + i]) * (one - y[ys + i]));
        }}
    }}

    /// eq(x, y+1) closed form (vm/r1cs.py _eq_plus_one;
    /// special_polys.rs:404-426).
    function eqPlusOne(Fr[] memory x, uint256 xs, Fr[] memory y, uint256 ys,
                       uint256 len) internal pure returns (Fr total)
    {{
        Fr one = Fr.wrap(1);
        for (uint256 k = 0; k < len; k++) {{
            Fr lower = one;
            for (uint256 i = 0; i < k; i++) {{
                lower = lower * x[xs + len - 1 - i] * (one - y[ys + len - 1 - i]);
            }}
            Fr kth = (one - x[xs + len - 1 - k]) * y[ys + len - 1 - k];
            Fr higher = one;
            for (uint256 i = k + 1; i < len; i++) {{
                higher = higher * (x[xs + len - 1 - i] * y[ys + len - 1 - i]
                    + (one - x[xs + len - 1 - i]) * (one - y[ys + len - 1 - i]));
            }}
            total = total + lower * kth * higher;
        }}
    }}

    /// Z(r) from the per-column witness openings (vm/r1cs.py
    /// evaluate_z_mle): first variable selects witness half vs the
    /// constant column at index 0 of the second half.
    function evalZMle(Fr[] memory rY, Fr[] memory segmentEvals)
        internal pure returns (Fr)
    {{
        require(segmentEvals.length == NUM_VARS, "bad segment count");
        Fr one = Fr.wrap(1);
        Fr rConst = rY[0];
        Fr[] memory rVarEq = eqEvals(rY, 1, VAR_BITS);
        Fr evalVars = Fr.wrap(0);
        for (uint256 i = 0; i < NUM_VARS; i++) {{
            evalVars = evalVars + rVarEq[i] * segmentEvals[i];
        }}
        Fr evalConst = one;
        for (uint256 i = 1; i < rY.length; i++) {{
            evalConst = evalConst * (one - rY[i]);
        }}
        return (one - rConst) * evalVars + rConst * evalConst;
    }}

    /// A/B/C MLEs at r = r_row || r_col (vm/r1cs.py
    /// evaluate_r1cs_matrix_mles).  stepsBits = log2(padded trace length).
    function evaluateR1CSMatrixMles(Fr[] memory r, uint256 stepsBits)
        internal pure returns (Fr aEval, Fr bEval, Fr cEval)
    {{
        uint256 totalRowsBits = CONSTR_BITS + stepsBits;
        // r_row = r[0 .. totalRowsBits), r_col = rest
        Fr[] memory eqRxConstr = eqEvals(r, 0, CONSTR_BITS);
        Fr eqRxRyStep = eqEvaluate(
            r, CONSTR_BITS, r, totalRowsBits + VAR_BITS + 1, stepsBits);
        Fr[] memory eqRyVar = eqEvals(r, totalRowsBits, VAR_BITS + 1);
        // constant column = index 2^(colBits-1): bits [1, 0, ..., 0]
        Fr colEqConstant = r[totalRowsBits];
        {{
            Fr one = Fr.wrap(1);
            for (uint256 i = totalRowsBits + 1; i < r.length; i++) {{
                colEqConstant = colEqConstant * (one - r[i]);
            }}
        }}
        Fr eqStepPlusOne = eqPlusOne(
            r, CONSTR_BITS, r, totalRowsBits + VAR_BITS + 1, stepsBits);

        aEval = _uniformA(eqRxConstr, eqRyVar, eqRxRyStep, colEqConstant);
        bEval = _uniformB(eqRxConstr, eqRyVar, eqRxRyStep, colEqConstant);
        cEval = _uniformC(eqRxConstr, eqRyVar, eqRxRyStep, colEqConstant);
        (aEval, bEval) = _nonUniform(aEval, bEval, eqRxConstr, eqRyVar,
                                     eqRxRyStep, eqStepPlusOne,
                                     colEqConstant);
    }}
"""

UNIFORM_FN = """
    function _uniform{name}(Fr[] memory eqRxConstr, Fr[] memory eqRyVar,
                            Fr eqRxRyStep, Fr colEqConstant)
        private pure returns (Fr)
    {{
        Fr t;
        Fr ct;
{body}
        return t * eqRxRyStep + ct * colEqConstant;
    }}
"""

NON_UNIFORM_FN = """
    function _nonUniform(Fr aEval, Fr bEval, Fr[] memory eqRxConstr,
                         Fr[] memory eqRyVar, Fr eqRxRyStep,
                         Fr eqStepPlusOne, Fr colEqConstant)
        private pure returns (Fr, Fr)
    {{
        Fr rowEq;
        Fr nu;
{body}
        return (aEval, bEval);
    }}
}}
"""


def generate(out_path: str | None = None) -> str:
    """The source of R1CSMatrix.sol; written to `out_path` when one is
    given."""
    spec = fr_spec()
    C = 4
    from ..instructions.rv32i import RV32I_INSTRUCTIONS
    layout = r1cs_mod.build_input_layout(C, len(RV32I_INSTRUCTIONS))
    name_to_index = {cls.name: k for k, cls in enumerate(RV32I_INSTRUCTIONS)}
    ml = MemoryLayout(DEFAULT_MAX_INPUT_SIZE, DEFAULT_MAX_OUTPUT_SIZE)
    builder, non_uniform = r1cs_mod.build_jolt_constraints(
        layout, C, RAM_START_ADDRESS - ml.ram_witness_offset, name_to_index)

    num_vars = len(layout)
    num_rows = len(builder.constraints)
    var_bits = _log2_pow2(num_vars)
    constr_bits = _log2_pow2(num_rows + 1)
    p = spec.p

    src = HEADER.format(C=C, num_vars=num_vars, num_rows=num_rows,
                        num_nu=len(non_uniform), var_bits=var_bits,
                        constr_bits=constr_bits)
    for idx, name in enumerate("ABC"):
        body = "\n".join(_gen_uniform_terms(builder.constraints, idx, p))
        src += UNIFORM_FN.format(name=name, body=body)
    src += NON_UNIFORM_FN.format(
        body="\n".join(_gen_non_uniform(non_uniform, num_rows, p)))

    if out_path is not None:
        with open(out_path, "w") as f:
            f.write(src)
    return src


if __name__ == "__main__":
    if len(sys.argv) > 1:
        generate(sys.argv[1])
    else:
        sys.stdout.write(generate())
