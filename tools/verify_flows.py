"""Quick end-to-end verification flows (the .claude/skills/verify checklist).

Run on the CPU backend with the virtual 8-device mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python tools/verify_flows.py
Flow 5 (bench smoke) runs on the card: python bench.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from concrete_ntt_tpu import native64, prime32
from concrete_ntt_tpu.golden.polymul import (
    negacyclic_convolution_mod,
    negacyclic_convolution_wrapping,
)

rng = np.random.default_rng(7)

# 1. README parity vector
plan = prime32.Plan.new(32, 1062862849)
x = rng.integers(0, plan.p, (1, 32), dtype=np.uint32)
assert np.array_equal(
    np.asarray(plan.inv(plan.fwd(x))),
    (x.astype(np.uint64) * 32 % plan.p).astype(np.uint32),
)
print("1. README N=32 vector OK")

# 2. prime32 polymul vs schoolbook oracle
n, p = 256, 1073479681
pl2 = prime32.Plan.new(n, p)
a = rng.integers(0, p, n, dtype=np.uint32)
b = rng.integers(0, p, n, dtype=np.uint32)
assert np.array_equal(
    np.asarray(pl2.negacyclic_polymul(a[None], b[None]))[0],
    np.array(
        negacyclic_convolution_mod(list(map(int, a)), list(map(int, b)), p),
        dtype=np.uint32,
    ),
)
print("2. polymul oracle OK")

# 3. native64 wrapping contract
pl3 = native64.Plan32.try_new(256)
av = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
bv = rng.integers(0, 1 << 64, 256, dtype=np.uint64)
assert np.array_equal(
    np.asarray(pl3.negacyclic_polymul(av[None], bv[None]))[0],
    np.array(
        negacyclic_convolution_wrapping(list(map(int, av)), list(map(int, bv)), 64),
        dtype=np.uint64,
    ),
)
print("3. native64 wrapping OK")

# 4. multi-device dry run (all sharded paths)
import __graft_entry__  # noqa: E402

__graft_entry__.dryrun_multichip(8)
print("4. dryrun_multichip(8) OK")
