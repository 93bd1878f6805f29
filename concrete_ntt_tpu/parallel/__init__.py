"""Multi-device parallelism (no reference analogue — SURVEY.md §2.12).

The reference is single-core SIMD; this package supplies the
scaling strategies the BASELINE.json north star specifies:

  * `fourstep` / `fourstep_mxu` — large-N transforms split N = N1×N2 with
    butterfly stages blocked per device and the inter-pass transpose as
    `lax.all_to_all` (the transform analogue of sequence parallelism; one
    all-to-all per transform on the four-step path).
  * `channels` — CRT residue channels sharded over a `ch` mesh axis
    (`ChannelShardedNative`): split → fwd → pointwise → inv run per channel
    shard with traced per-channel tables; the only cross-channel collective
    is the all-gather feeding the CRT reconstruction. Composes with dp
    (batch) and sp (four-step) axes in one shard_map.
  * data-parallel batches: shard the leading batch axis (`batch_axis=` on
    any factory here, or plain jit sharding on any plan method — everything
    is elementwise or batch-independent).

See tests/test_channels.py for the composed dp × ch × sp north-star config
(native128, N=2^16) and __graft_entry__.dryrun_multichip for the driver
recipe.
"""

from . import channels, fourstep, fourstep_mxu

__all__ = ["channels", "fourstep", "fourstep_mxu"]
