"""concrete_ntt_tpu — a batched negacyclic NTT framework in JAX/XLA.

Built from scratch in JAX/XLA with the full capability set of the
Rust `concrete-ntt` library (see SURVEY.md for the reference analysis):

  * `prime32` / `prime64` — negacyclic NTT plans over Z/pZ for 32- and
    64-bit primes (Shoup / Montgomery / Goldilocks kernels in u32 limb
    arithmetic), batch-first and jit/vmap-composable.
  * `native32` / `native64` / `native128` — NTTs simulating *wrapping*
    arithmetic mod 2^32 / 2^64 / 2^128 via CRT over several primes with
    guaranteed signed-truncation semantics.
  * `native_binary32/64/128` — variants optimized for {0,1} operands.
  * `product` — generic product-of-distinct-primes plan (tfhe-rs
    integration surface).
  * `parallel` — multi-device sharding: data-parallel batches, CRT
    channels across devices, four-step large-N transforms with all-to-all
    stage exchange.
  * `tables` — NTT-friendly prime tables + CRT constants.
  * `golden` — exact bigint oracle models (test layer).

Conventions (identical to the reference): `fwd` maps standard-order
coefficients to bit-reversed NTT values in [0, p); `inv` maps back without
normalization, so inv(fwd(x)) == n·x; normalization is fused into
`mul_assign_normalize` / explicit in `normalize`.
"""

from . import (
    native32,
    native64,
    native128,
    native_binary32,
    native_binary64,
    native_binary128,
    prime32,
    prime64,
    product,
    tables,
)

__version__ = "0.1.0"

__all__ = [
    "prime32",
    "prime64",
    "native32",
    "native64",
    "native128",
    "native_binary32",
    "native_binary64",
    "native_binary128",
    "product",
    "tables",
]
