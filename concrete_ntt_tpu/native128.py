"""Native NTT simulating wrapping arithmetic mod 2^128 via CRT.

Capability parity with src/native128.rs: Plan32 = 10× 30-bit prime32 channels
(~300 bits, native128.rs:6-17,123-137). The reference has no Plan52 tier at
width 128 (native128.rs) and neither do we.

u128 values cross the device boundary as (..., n, 4) uint32 limb arrays
(JAX has no 128-bit integers; neither does NumPy), or as lists of Python
ints for host convenience.
"""

from __future__ import annotations

from dataclasses import dataclass

from ._native_common import NativePlanBase, build_plans32
from .ops import crt as crt_ops
from .tables import NATIVE128_PRIMES, native_channel_primes


@dataclass(frozen=True)
class Plan32(NativePlanBase):
    @classmethod
    def try_new(cls, n: int) -> "Plan32 | None":
        primes = native_channel_primes(10, n)
        if primes is None:
            return None
        plans = build_plans32(n, primes)
        if not plans:
            return None
        return cls(n=n, width=128, primes=primes, plans=plans, tier="plan32")

    def _reconstruct(self, residues):
        from . import crt_mxu

        if crt_mxu.mxu_lift_enabled():
            return crt_mxu.rec_u128_from10(residues, self.primes)
        return crt_ops.rec_u128_from10(residues, self.primes)

    def ntt_0(self):
        return self.plans[0]

    def ntt_1(self):
        return self.plans[1]

    def ntt_2(self):
        return self.plans[2]

    def ntt_3(self):
        return self.plans[3]

    def ntt_4(self):
        return self.plans[4]

    def ntt_5(self):
        return self.plans[5]

    def ntt_6(self):
        return self.plans[6]

    def ntt_7(self):
        return self.plans[7]

    def ntt_8(self):
        return self.plans[8]

    def ntt_9(self):
        return self.plans[9]
