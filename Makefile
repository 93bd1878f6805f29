# Developer entry points (parity with the reference's Makefile targets:
# test / bench / lint — Makefile:79-110 there).

PY ?= python

.PHONY: test test-fast bench bench-full bench-headline scaling native clean \
	baseline lint gpu smoke ci

# one-command release gate: lint -> CPU suite (fast leg skips `-m slow`
# tests) -> on a machine with an NVIDIA GPU, the GPU leg (`pytest -m gpu`,
# chip_smoke.py, headline bench); without a card the GPU leg reports
# "not run: no GPU". `make ci FULL=1` runs the slow tests too.
ci:
	FULL=$(FULL) $(PY) tools/ci_gate.py

# static-analysis gate, warnings-as-errors (clippy -D warnings parity,
# reference Makefile:51-63; this image has no ruff/mypy, so the gate is the
# repo's AST linter — see tools/lint.py for the check list)
lint:
	$(PY) tools/lint.py

# measured per-core AVX512 CPU baseline (the headline denominator's
# provenance; see BASELINE.md)
baseline:
	g++ -O3 -march=native -std=c++17 -o /tmp/baseline_avx512 \
		benches/baseline_avx512.cpp
	/tmp/baseline_avx512 16384

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q

test-fast:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -q -x -m "not slow"

# the tests that need the card (run on a machine with an NVIDIA GPU)
gpu:
	$(PY) -m pytest tests/ -q -m gpu

# the main path at full width on the card, bit-exact vs golden/
smoke:
	$(PY) chip_smoke.py

# criterion-parity grid (representative sizes)
bench:
	$(PY) benches/run.py

# the reference's full n grid (slow: many shapes to compile)
bench-full:
	$(PY) benches/run.py --full

# the driver headline metric (one JSON line)
bench-headline:
	$(PY) bench.py

# multi-device scaling harness (runs on whatever mesh is available)
scaling:
	$(PY) benches/scaling.py

# force-rebuild the native host-math library
native:
	rm -f concrete_ntt_tpu/_native/*.so
	$(PY) -c "from concrete_ntt_tpu import _native; assert _native.lib() is not None, 'toolchain unavailable'; print('native tier OK')"

clean:
	rm -f concrete_ntt_tpu/_native/*.so
	find . -name __pycache__ -type d -exec rm -rf {} +
