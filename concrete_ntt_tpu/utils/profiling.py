"""Profiling and roofline helpers (aux subsystem; SURVEY.md §5).

The reference has no in-library tracing (criterion benches only); here the
equivalents are jax.profiler traces, a reduction of a trace to per-operation
device time and busy share, and roofline shares against the published peaks
of the device the run is on.
"""

from __future__ import annotations

import collections
import contextlib
import glob
import os
import re
import time
from dataclasses import dataclass

import numpy as np

# Published dense peaks per `device_kind` as JAX reports it. A kind that is
# not listed is an error, never a default.
#   NVIDIA H100 SXM: NVIDIA's H100 Tensor Core GPU data sheet (int8 tensor
#   cores without sparsity; HBM3 bandwidth), at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"int8_ops_per_s": 1979e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context: view with TensorBoard / xprof, or reduce
    with device_op_times()."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def chain_time(step, args, *, length: int = 128, reps: int = 5):
    """Per-step latency of `step` via on-device lax.scan chains.

    Times a chain of `length` dependent applications minus a chain of one,
    so per-call dispatch and host-transfer costs cancel and the difference
    is device work. Every timing ends in block_until_ready. `step` maps a
    pytree carry to a pytree carry.
    """
    import jax
    import jax.numpy as jnp

    args = jax.tree_util.tree_map(jnp.asarray, args)

    def make(k):
        @jax.jit
        def f(ops):
            def body(carry, _):
                return step(carry), None

            out, _ = jax.lax.scan(body, ops, None, length=k)
            # Reduce EVERY element of EVERY carry leaf: a [:1] slice-touch is
            # not DCE-proof for ELEMENTWISE stages — XLA slices the whole
            # dependency chain down to element [0] and times nothing (the
            # transform stages were immune only because each output element
            # depends on all inputs). The full reduction runs once, outside
            # the scan, so it cancels in the (t_K - t_1)/(K - 1) difference.
            return sum(
                jnp.sum(leaf.astype(jnp.float32))
                for leaf in jax.tree_util.tree_leaves(out)
            )

        return f

    f_k, f_1 = make(length), make(1)
    f_k(args).block_until_ready()
    f_1(args).block_until_ready()
    best_k = best_1 = float("inf")
    for _i in range(reps):
        t0 = time.perf_counter()
        f_k(args).block_until_ready()
        best_k = min(best_k, time.perf_counter() - t0)
        t0 = time.perf_counter()
        f_1(args).block_until_ready()
        best_1 = min(best_1, time.perf_counter() - t0)
    return max(best_k - best_1, 1e-9) / (length - 1)


@dataclass
class Roofline:
    """Achieved rates of one kernel or step and their shares of the
    device's published peaks."""

    seconds: float
    hbm_bytes: int
    int8_ops: int
    kind: str

    @property
    def hbm_share(self) -> float:
        return self.hbm_bytes / self.seconds / peaks(self.kind)["hbm_bytes_per_s"]

    @property
    def int8_share(self) -> float:
        return self.int8_ops / self.seconds / peaks(self.kind)["int8_ops_per_s"]

    @property
    def share(self) -> float:
        """Roofline share: least possible time over measured time."""
        return max(self.hbm_share, self.int8_share)

    @property
    def bound(self) -> str:
        return "hbm" if self.hbm_share >= self.int8_share else "int8"


def fourstep_int8_ops(n: int, batch: int, e_col: int, e_row: int,
                      n_dplanes: int = 4) -> int:
    """int8 operations (2 per MAC) of one four-step transform of [batch, n]:
    the column pass contracts e_col·n1 digit rows into n_dplanes·n1 columns,
    the row pass e_row·n2 into n_dplanes·n2."""
    log2n = n.bit_length() - 1
    n1 = 1 << (log2n // 2)
    n2 = n // n1
    macs = batch * n2 * (e_col * n1) * (n_dplanes * n1)
    macs += batch * n1 * (e_row * n2) * (n_dplanes * n2)
    return 2 * macs


def device_op_times(trace_dir: str) -> tuple[dict, dict]:
    """Reduce the newest jax.profiler trace under `trace_dir` to
    ({op name: (count, total device ns)}, {"window_ns", "busy_ns"}) over the
    GPU planes. Busy is the union of the operation intervals; the window
    runs from the first operation's start to the last one's end."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    pd = ProfileData.from_file(files[-1])
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    if not events:
        raise ValueError(f"no device operations in the trace under {trace_dir}")
    ops = collections.defaultdict(lambda: [0, 0.0])
    for name, _, dur in events:
        ops[name][0] += 1
        ops[name][1] += dur
    spans = [(s, s + d) for _, s, d in events]
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    return (
        {k: (c, t) for k, (c, t) in ops.items()},
        {"window_ns": float(window), "busy_ns": busy_ns(spans)},
    )


def busy_ns(spans) -> float:
    """Length of the union of [start, end) intervals."""
    spans = sorted(spans)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return float(busy + cur_e - cur_s)


def seconds_per_call(fn, args, calls: int, samples: int = 5) -> float:
    """Median over `samples` of the host-clock time of `calls` back-to-back
    calls ended by one block_until_ready, divided by `calls`: the rate a
    stream of calls sustains, per call."""
    import jax

    ts = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / calls)
    return float(np.median(ts))


_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2,
                "bf16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8}
_SHAPE = re.compile(r"\b(pred|[suf]\d+|bf16)\[([0-9,]*)\]")
_DEF = re.compile(r"^\s*(?:ROOT )?%([\w.\-]+) = (\(.*?\)|\S+) ([\w\-]+)\((.*?)\)")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(text):
        total += _DTYPE_BYTES[dt] * int(np.prod([int(d) for d in dims.split(",") if d]))
    return total


def hlo_op_bytes(hlo_text: str) -> dict:
    """{trace name: bytes read + written per call} from the optimized HLO's
    ENTRY computation (compiled.as_text()). An instruction moves its result
    shape plus the shapes of its operands. Instructions that share one
    compiled kernel (the same `deduplicated_name`) appear in a trace under
    one member's name, so every member maps to the total of its group.
    Trace events name an instruction with '.' replaced by '_'."""
    entry = hlo_text[hlo_text.index("\nENTRY "):]
    shapes, group_of, totals = {}, {}, collections.Counter()
    for line in entry.split("\n")[1:]:
        m = _DEF.match(line)
        if not m:
            continue
        name, shape, _opcode, operands = m.groups()
        shapes[name] = _shape_bytes(shape)
        names = re.findall(r"%([\w.\-]+)", operands)
        dedup = re.search(r'deduplicated_name="([\w.\-]+)"', line)
        group = dedup.group(1) if dedup else name
        group_of[name] = group
        totals[group] += shapes[name] + sum(shapes.get(o, 0) for o in names)
    return {n.replace(".", "_"): totals[g] for n, g in group_of.items()}
