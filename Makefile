# Local CI entry point — mirrors .github/workflows/ci.yaml (which mirrors
# the reference's .github/workflows/ci.yaml: lint + test).
.PHONY: ci lint test test-all test-gpu native bench chip-smoke

ci: lint native test

lint:
	python tools/lint.py

native:
	$(MAKE) -C solstrale/native

test:
	python -m pytest tests/ -q -m "not slow"

test-all:
	python -m pytest tests/ -q

# card-only tests, on a machine with a CUDA GPU
test-gpu:
	JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu

bench:
	python bench.py

chip-smoke:
	python chip_smoke.py
