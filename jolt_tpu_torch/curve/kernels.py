"""G1 point kernels: complete projective add (K5), Jacobian add (K6) and
Jacobian doubling (K7).

Points are coordinate triples of Fq limb tensors [16, *b] in Montgomery
form.  On CPU tensors each wrapper runs the plain PyTorch version beside
it (jolt_tpu/curve/device.py's XLA formulas, op for op); on CUDA tensors
it checks the operands, allocates the outputs and launches the kernel of
csrc/point.cu, counting the launch.  It never falls back to the plain
version on the card.

| wrapper    | replaces (jolt_tpu/curve/pallas_point.py) | source        |
| proj_cadd  | proj_cadd_pallas (K5)                     | csrc/point.cu |
| jac_add    | jac_add_pallas (K6)                       | csrc/point.cu |
| jac_double | jac_double_pallas (K7)                    | csrc/point.cu |
"""
from __future__ import annotations

import torch

from .. import _native as nat
from ..field import arith
from ..field.spec import NUM_LIMBS, fq_spec

FQ = fq_spec()
L = NUM_LIMBS

_POINT_ARGS = [nat.vptr] * 9 + [nat.i64] * 8 + [nat.u32p, nat.vptr]

PROJ_CADD = nat.CudaKernel(
    "proj_cadd", "point", "jt_proj_cadd", _POINT_ARGS,
    "jolt_tpu/curve/pallas_point.py:158 proj_cadd_pallas",
    "point_kernel<0>", 128)
JAC_ADD = nat.CudaKernel(
    "jac_add", "point", "jt_jac_add", _POINT_ARGS,
    "jolt_tpu/curve/pallas_point.py:252 jac_add_pallas",
    "point_kernel<1>", 128)
JAC_DOUBLE = nat.CudaKernel(
    "jac_double", "point", "jt_jac_double",
    [nat.vptr] * 6 + [nat.i64] * 5 + [nat.u32p, nat.vptr],
    "jolt_tpu/curve/pallas_point.py:261 jac_double_pallas",
    "point_kernel<2>", 128)


def _mul(x, y):
    return arith.mont_mul(FQ, x, y)


def _add(x, y):
    return arith.add(FQ, x, y)


def _sub(x, y):
    return arith.sub(FQ, x, y)


def _dbl(x):
    return arith.add(FQ, x, x)


def _iszero(x):
    return torch.all(x == 0, dim=0)


def _sel(cond, a, b):
    return torch.where(cond[None], a, b)


def jac_double_plain(X, Y, Z):
    """a = 0 Jacobian doubling (dbl-2009-l); Z = 0 stays at infinity."""
    A = _mul(X, X)
    B = _mul(Y, Y)
    C = _mul(B, B)
    xb = _add(X, B)
    D = _dbl(_sub(_sub(_mul(xb, xb), A), C))
    E = _add(_add(A, A), A)
    F = _mul(E, E)
    X3 = _sub(F, _dbl(D))
    Y3 = _sub(_mul(E, _sub(D, X3)), _dbl(_dbl(_dbl(C))))
    Z3 = _dbl(_mul(Y, Z))
    return X3, Y3, Z3


def jac_add_plain(p1, p2):
    """Full Jacobian addition with masked special cases
    (jolt_tpu/curve/device.py:93-132)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    z1z1 = _mul(Z1, Z1)
    z2z2 = _mul(Z2, Z2)
    u1 = _mul(X1, z2z2)
    u2 = _mul(X2, z1z1)
    s1 = _mul(_mul(Y1, Z2), z2z2)
    s2 = _mul(_mul(Y2, Z1), z1z1)
    h = _sub(u2, u1)
    rr = _sub(s2, s1)
    h2 = _mul(h, h)
    h3 = _mul(h, h2)
    v = _mul(u1, h2)
    X3 = _sub(_sub(_mul(rr, rr), h3), _dbl(v))
    Y3 = _sub(_mul(rr, _sub(v, X3)), _mul(s1, h3))
    Z3 = _mul(_mul(Z1, Z2), h)

    dX, dY, dZ = jac_double_plain(X1, Y1, Z1)

    p1_inf = _iszero(Z1)
    p2_inf = _iszero(Z2)
    h_zero = _iszero(h) & ~p1_inf & ~p2_inf
    r_zero = _iszero(rr)
    is_dbl = h_zero & r_zero
    is_opp = h_zero & ~r_zero

    X3 = _sel(is_dbl, dX, X3)
    Y3 = _sel(is_dbl, dY, Y3)
    Z3 = _sel(is_dbl, dZ, Z3)
    Z3 = _sel(is_opp, torch.zeros_like(Z3), Z3)
    X3 = _sel(p2_inf, X1, _sel(p1_inf, X2, X3))
    Y3 = _sel(p2_inf, Y1, _sel(p1_inf, Y2, Y3))
    Z3 = _sel(p2_inf, Z1, _sel(p1_inf, Z2, Z3))
    return X3.int(), Y3.int(), Z3.int()


def proj_cadd_plain(p1, p2):
    """Complete projective addition, a = 0, b3 = 9 (Renes-Costello-Batina
    2016 Alg. 7; jolt_tpu/curve/device.py:135-161)."""
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    b3 = lambda t: _add(_dbl(_dbl(_dbl(t))), t)          # 9t
    t0 = _mul(X1, X2)
    t1 = _mul(Y1, Y2)
    t2 = _mul(Z1, Z2)
    t3 = _sub(_mul(_add(X1, Y1), _add(X2, Y2)), _add(t0, t1))
    t4 = _sub(_mul(_add(Y1, Z1), _add(Y2, Z2)), _add(t1, t2))
    X3 = _mul(_add(X1, Z1), _add(X2, Z2))
    Y3 = _sub(X3, _add(t0, t2))
    t0 = _add(_dbl(t0), t0)
    t2 = b3(t2)
    Z3 = _add(t1, t2)
    t1 = _sub(t1, t2)
    Y3 = b3(Y3)
    X3 = _sub(_mul(t3, t1), _mul(t4, Y3))
    Y3 = _add(_mul(Y3, t0), _mul(t1, Z3))
    Z3 = _add(_mul(Z3, t4), _mul(t0, t3))
    return X3, Y3, Z3


def _check_points(name: str, ts) -> None:
    """The layout the kernels take, checked on every device so that a CPU
    run finds what the card would refuse."""
    shape = ts[0].shape
    for t in ts:
        if t.shape != shape or t.dim() < 1 or t.shape[0] != L:
            raise ValueError(f"{name}: expected equal [16, ...] "
                             f"coordinates, got {[tuple(x.shape) for x in ts]}")
        if not t[0].is_contiguous():
            raise ValueError(f"{name}: each limb row must be contiguous")


def _launch_point(kernel: nat.CudaKernel, ts):
    """Launch a point kernel on the coordinates `ts` (three for K7, six
    for K5/K6): input pointers, output pointers, n, input limb strides,
    output limb stride, the field, the stream."""
    nat.require_cuda(kernel.name, *ts)
    shape = ts[0].shape
    outs = [torch.empty(shape, dtype=torch.int32, device=ts[0].device)
            for _ in range(3)]
    n = outs[0][0].numel()
    if n == 0:
        return tuple(outs)
    kernel.launch(*[nat.ptr(t) for t in ts], *[nat.ptr(o) for o in outs], n,
                  *[t.stride(0) for t in ts], n,
                  nat.words(FQ.words32()), nat.stream(outs[0]))
    return tuple(outs)


def proj_cadd(p1, p2):
    """Complete projective add of two ([16, *b],) * 3 coordinate triples."""
    ts = (*p1, *p2)
    _check_points("proj_cadd", ts)
    if all(t.device.type == "cpu" for t in ts):
        return proj_cadd_plain(p1, p2)
    return _launch_point(PROJ_CADD, ts)


def jac_add(p1, p2):
    """Jacobian add (infinity is Z = 0) of two coordinate triples."""
    ts = (*p1, *p2)
    _check_points("jac_add", ts)
    if all(t.device.type == "cpu" for t in ts):
        return jac_add_plain(p1, p2)
    return _launch_point(JAC_ADD, ts)


def jac_double(p):
    """Jacobian doubling (a = 0; infinity is Z = 0) of a coordinate triple."""
    ts = tuple(p)
    _check_points("jac_double", ts)
    if all(t.device.type == "cpu" for t in ts):
        return jac_double_plain(*ts)
    return _launch_point(JAC_DOUBLE, ts)
