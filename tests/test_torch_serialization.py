"""The port's arkworks encodings (utils/ark_serialize.py) and its
preprocessing seed (utils/serialization.py) against jolt_tpu's.

Fr vectors, G1 points compressed and uncompressed, G2 points compressed,
the Fq2 square root's edge cases and the SRS file, each on the same
values, made from numpy.random.default_rng, in both packages: the bytes
must be equal and read back to the same points.  The preprocessing seed of
a guest's bytecode rows must be jolt_tpu's bytes and read back.  Proof
bytes are held in tests/test_torch_vm.py (the fib(3) proofs) and
tests/test_torch_surge.py.
"""
import numpy as np
import pytest

from jolt_tpu.curve import bn254 as jbn
from jolt_tpu.utils import ark_serialize as jas
from jolt_tpu.utils import serialization as jser
from jolt_tpu.vm import guests as jguests
from jolt_tpu.vm import host as jhost
from jolt_tpu.vm.rv32i_vm import rv32i_vm as j_rv32i_vm
from jolt_tpu_torch.curve import bn254 as bn
from jolt_tpu_torch.field.spec import FR_MODULUS
from jolt_tpu_torch.utils import ark_serialize as pas
from jolt_tpu_torch.utils import serialization as ser
from jolt_tpu_torch.vm import guests
from jolt_tpu_torch.vm.host import trace_program
from jolt_tpu_torch.vm.rv32i_vm import rv32i_vm

Q = bn.Q


def _ints(rng, n, modulus):
    """n values below `modulus`, with 0, 1 and modulus - 1 among them."""
    words = rng.integers(0, 1 << 32, (n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % modulus
            for row in words]
    return [0, 1, modulus - 1] + vals


def _g1_points(rng, n):
    pts = [bn.G1Jacobian(1, 2, 1).mul(k).to_affine()
           for k in _ints(rng, n, FR_MODULUS)[1:]]
    return pts + [bn.G1Affine.identity()]


def _j_g1(p):
    return jbn.G1Affine(p.x, p.y, p.is_infinity)


def test_fr_bytes_match_jolt_tpu():
    vals = _ints(np.random.default_rng(1), 64, FR_MODULUS)
    for v in vals:
        b = pas.fr_to_bytes(v)
        assert b == jas.fr_to_bytes(v)
        assert pas.fr_from_bytes(b) == jas.fr_from_bytes(b) == v
    with pytest.raises(ValueError):
        pas.fr_from_bytes(FR_MODULUS.to_bytes(32, "little"))
    with pytest.raises(ValueError):
        pas.fr_from_bytes(b"\x00" * 31)


def test_g1_bytes_match_jolt_tpu():
    for p in _g1_points(np.random.default_rng(2), 12):
        c, u = pas.g1_to_compressed(p), pas.g1_to_uncompressed(p)
        assert c == jas.g1_to_compressed(_j_g1(p))
        assert u == jas.g1_to_uncompressed(_j_g1(p))
        for back, jback in ((pas.g1_from_compressed(c),
                             jas.g1_from_compressed(c)),
                            (pas.g1_from_uncompressed(u),
                             jas.g1_from_uncompressed(u))):
            assert back == p
            assert (back.x, back.y, back.is_infinity) == \
                (jback.x, jback.y, jback.is_infinity)
    with pytest.raises(ValueError):             # x = 0: y^2 = 3 has no root
        pas.g1_from_compressed(b"\x00" * 32)


def _g2_points(rng, n):
    g = bn.G2Affine.generator()
    return [g.mul(k) for k in _ints(rng, n, FR_MODULUS)[1:]] \
        + [bn.G2Affine.identity()]


def test_g2_bytes_match_jolt_tpu():
    for p in _g2_points(np.random.default_rng(3), 4):
        b = pas.g2_to_compressed(p)
        jp = jbn.G2Affine(p.x, p.y, p.is_infinity)
        assert b == jas.g2_to_compressed(jp)
        back, jback = pas.g2_from_compressed(b), jas.g2_from_compressed(b)
        assert back == p
        assert (back.x, back.y) == (jback.x, jback.y)


def test_fq2_sqrt_edge_cases_match_jolt_tpu():
    rng = np.random.default_rng(4)
    t = _ints(rng, 6, Q)
    cases = [(0, 0), (4, 0), (Q - 4, 0)]            # 0, c1 = 0 square and not
    cases += [(a, 0) for a in t]                    # c1 = 0 at random
    cases += [bn.fq2_square((a, b)) for a, b in zip(t, t[::-1])]
    cases += [bn.fq2_square((0, a)) for a in t]     # pure c0 = -a^2
    for a in cases:
        r = pas._fq2_sqrt(a)
        assert r == jas._fq2_sqrt(a)
        assert bn.fq2_square(r) == (a[0] % Q, a[1] % Q)
    # a non-square: its norm c0^2 + c1^2 is not a square in Fq
    bad = next(a for a in ((9, 1), (1, 1), (2, 1), (3, 1))
               if pow((a[0] ** 2 + a[1] ** 2) % Q, (Q - 1) // 2, Q) != 1)
    with pytest.raises(ValueError):
        pas._fq2_sqrt(bad)


def test_srs_file_matches_jolt_tpu(tmp_path):
    rng = np.random.default_rng(6)
    g1 = _g1_points(rng, 7)
    g2 = bn.G2Affine.generator()
    beta = g2.mul(0x6A6F6C74)
    path, jpath = tmp_path / "port.srs", tmp_path / "jolt_tpu.srs"
    pas.save_srs(str(path), g1, g2, beta)
    jas.save_srs(str(jpath), [_j_g1(p) for p in g1],
                 jbn.G2Affine(g2.x, g2.y), jbn.G2Affine(beta.x, beta.y))
    assert path.read_bytes() == jpath.read_bytes()
    got_g1, got_g2, got_beta = pas.load_srs(str(path))
    assert got_g1 == g1 and got_g2 == g2 and got_beta == beta
    jg1, jg2, jbeta = jas.load_srs(str(path))
    assert [(p.x, p.y, p.is_infinity) for p in jg1] == \
        [(p.x, p.y, p.is_infinity) for p in g1]
    path.write_bytes(path.read_bytes() + b"\x00")
    with pytest.raises(ValueError, match="trailing"):
        pas.load_srs(str(path))


def test_preprocessing_seed_matches_jolt_tpu():
    """multi_function(3)'s bytecode rows (JAL/JALR, stores, virtual-free)
    and a memory image: jolt_tpu's bytes, read back to the same rows."""
    _, _, rows = trace_program(guests.multi_function_program(3), rv32i_vm())
    _, _, jrows = jhost.trace_program(jguests.multi_function_program(3),
                                      j_rv32i_vm(), native=False)
    args = (b"\x01\x02\x03", 0x80000000, 4096, 4096)
    data = ser.serialize_preprocessing_seed(rows, *args)
    assert data == jser.serialize_preprocessing_seed(jrows, *args)
    back, *rest = ser.deserialize_preprocessing_seed(data)
    assert back == rows
    assert tuple(rest) == args
    with pytest.raises(ValueError, match="trailing"):
        ser.deserialize_preprocessing_seed(data + b"\x00")
