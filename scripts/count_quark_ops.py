#!/usr/bin/env python3
"""Count the PyTorch ops that a Quarks hybrid prove issues, on the CPU.

    python scripts/count_quark_ops.py [LOG2_LEAVES ...]     # default 8 10

B = 16 circuits of 2^k leaves (numpy default_rng(12), as chip_smoke.py's
phase 12) are proved with HyperKZG over a 2^(k-4)-point SRS, and the
opening accumulator is reduced and proved.  Each call of a kernel wrapper
(K1-K7) counts as one launch, as it is on the card; every other op
dispatched to PyTorch (the limb loops of field/arith.py, copies, cats) is
counted one by one, with the three innermost port frames that issued it.
On the card each such op is a small host-issued launch, so the count
predicts the prove's host time; the CPU's own times mean nothing for it.
"""
from __future__ import annotations

import collections
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from jolt_tpu_torch.commitment.hyperkzg import HyperKZG  # noqa: E402
from jolt_tpu_torch.curve import device as cd  # noqa: E402
from jolt_tpu_torch.field import device as fd  # noqa: E402
from jolt_tpu_torch.field import kernels as fk  # noqa: E402
from jolt_tpu_torch.field.spec import fr_spec  # noqa: E402
from jolt_tpu_torch.poly.opening_proof import \
    ProverOpeningAccumulator  # noqa: E402
from jolt_tpu_torch.subprotocols.grand_product_quarks import \
    QuarkGrandProduct  # noqa: E402
from jolt_tpu_torch.transcript import Transcript  # noqa: E402

B = 16
SITES = ((fk, ("mont_mul", "mont_mul_bl", "gp_pair_evals", "gp_pair_bind")),
         (cd, ("proj_cadd", "jac_add", "jac_double")))


class OpCounter(TorchDispatchMode):
    """Counts dispatched ops outside the kernel wrappers, and the
    wrappers' calls."""

    def __init__(self):
        super().__init__()
        self.depth = 0
        self.ops = 0
        self.launches = collections.Counter()
        self.sources = collections.Counter()

    def wrap(self, mod, name):
        fn = getattr(mod, name)

        def wrapped(*args, **kwargs):
            if self.depth == 0:
                self.launches[name] += 1
            self.depth += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.depth -= 1
        setattr(mod, name, wrapped)
        return fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.depth == 0:
            self.ops += 1
            frames = [f for f in traceback.extract_stack(limit=30)
                      if "jolt_tpu_torch" in f.filename][-3:]
            self.sources[" <- ".join(f"{Path(f.filename).name}:{f.name}"
                                     for f in reversed(frames))] += 1
        return func(*args, **(kwargs or {}))


def count(log_n: int) -> OpCounter:
    spec = fr_spec()
    vals = np.random.default_rng(12).integers(
        1, 1 << 63, size=(B, 1 << log_n), dtype=np.uint64)
    pcs = HyperKZG.setup(1 << (log_n - 4), device="cpu")
    counter = OpCounter()
    originals = [(mod, name, counter.wrap(mod, name))
                 for mod, names in SITES for name in names]
    try:
        with counter:
            leaves = fd.u64_to_mont_device(spec, vals, "cpu")
            gp = QuarkGrandProduct.construct(leaves, spec)
            gp.claims()
            t = Transcript(b"quark")
            acc = ProverOpeningAccumulator(spec)
            gp.prove_grand_product(acc, t, pcs)
            acc.reduce_and_prove(pcs, t)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    return counter


def main(argv=None) -> None:
    torch.set_num_threads(4)
    for log_n in [int(a) for a in (argv or sys.argv[1:])] or [8, 10]:
        c = count(log_n)
        print(f"B={B} leaves=2^{log_n}: {c.ops} ops besides the kernels; "
              f"kernel launches {dict(c.launches)}", flush=True)
        for src, n in c.sources.most_common(5):
            print(f"  {n:8d}  {src}")


if __name__ == "__main__":
    main()
