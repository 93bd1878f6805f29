"""Batched product-plan polymul with Accumulate — the tfhe-rs NTT-PBS
composite (no reference example; hot-loop anchor product.rs:444-445).

A `product.Plan` over two 30-bit primes computes polynomial products modulo
m = p0*p1 and accumulates them into a running buffer in one fused call —
the device shape of an external-product loop. Batch-first: every array carries
a leading batch axis and the whole loop jits.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np

from concrete_ntt_tpu import product
from concrete_ntt_tpu.golden.polymul import negacyclic_convolution_mod
from concrete_ntt_tpu.tables import PRIMES32

N = 1024
B = 4
P0, P1 = PRIMES32[0], PRIMES32[1]
M = P0 * P1

plan = product.Plan.new(N, M, (P0, P1))
rng = np.random.default_rng(0)

acc = np.zeros((B, N), dtype=np.uint64)
terms = [
    (
        rng.integers(0, M, (B, N)).astype(np.uint64),
        rng.integers(0, M, (B, N)).astype(np.uint64),
    )
    for _ in range(3)
]
for lhs, rhs in terms:
    acc = plan.negacyclic_polymul(lhs, rhs, mode=product.ACCUMULATE, standard=acc)

for b in range(B):
    want = np.zeros(N, dtype=object)
    for lhs, rhs in terms:
        conv = negacyclic_convolution_mod(lhs[b].tolist(), rhs[b].tolist(), M)
        want = (want + np.array(conv, dtype=object)) % M
    assert np.asarray(acc)[b].tolist() == [int(v) for v in want]
print(f"ok: batched accumulate of 3 products mod {M:#x}, n={N}, batch={B}")
