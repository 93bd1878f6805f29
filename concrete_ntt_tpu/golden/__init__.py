"""Golden (oracle) models: exact bigint implementations of every algorithm.

Test-support layer per SURVEY.md §7 M1 — all JAX kernels are asserted
bit-exact against these.
"""

from . import crt, ntt, polymul

__all__ = ["crt", "ntt", "polymul"]
