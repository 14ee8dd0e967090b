# Top-level build/test entry points (mirrors the reference's Makefile:20-33
# build/test/check targets, retargeted: Go build -> C++ native build,
# vacuous `go test ./...` -> a real pytest pyramid).

include versions.mk

PYTHON ?= python3

.PHONY: all build native test test-fast bench lint lint-fast typecheck clean image kind-smoke

all: build

build: native

native:
	$(MAKE) -C native

test: native
	$(PYTHON) -m pytest tests/ -x -q

test-fast:
	$(PYTHON) -m pytest tests/ -x -q -k "not native and not bash"

bench:
	$(PYTHON) bench.py

# BASELINE config 1 executed: label->state round trip on a kind cluster
# (or the manifest-faithful process smoke when docker is unavailable —
# docs/kind-smoke.md has a captured run and the why)
kind-smoke:
	bash scripts/kind-smoke.sh

# Three layers, weakest to strongest: compileall (syntax), ruff
# (critical pyflakes classes, ruff.toml), ccaudit (project invariants:
# lock discipline, blocking-under-lock, label hygiene, exception
# discipline, metric names — docs/analysis.md). CI runs the same three
# so local and CI agree; ruff is skipped with a notice when not
# installed (pip install -r requirements-dev.txt).
lint:
	$(PYTHON) -m compileall -q tpu_cc_manager bench.py __graft_entry__.py scripts
	bash -n scripts/tpu-cc-manager.sh scripts/kind-smoke.sh
	@if command -v ruff >/dev/null 2>&1; then ruff check .; \
	else echo "lint: ruff not installed; skipping (pip install -r requirements-dev.txt)"; fi
	$(PYTHON) -m tpu_cc_manager.analysis
	$(PYTHON) -m tpu_cc_manager_torch.analysis

# Changed-files analyzer pass (ISSUE 17): ccaudit reporting only on
# the .py files your branch touches vs origin/main (falls back to HEAD
# for a detached/CI checkout). The analysis still runs whole-program
# over the default surface — whole-program facts computed on a slice
# would diverge from the gate's — so this reports exactly what `make
# lint` would flag in YOUR files, minus the manifest cross-check. The
# full run stays the merge gate (and is itself wall-time gated by the
# bench's ccaudit_wall_s ceiling). --cache (ISSUE 18) reloads pickled
# per-module facts from .ccaudit_cache/ for unchanged modules, so the
# inner loop re-parses only what you edited.
lint-fast:
	@base=$$(git merge-base origin/main HEAD 2>/dev/null || git rev-parse HEAD); \
	changed=$$(git diff --name-only $$base -- '*.py'); \
	if [ -z "$$changed" ]; then echo "lint-fast: no .py changes vs $$base"; \
	else $(PYTHON) -m tpu_cc_manager.analysis --files --cache $$changed; fi

# Static types over the typed-core subset (mypy.ini `files`): the
# protocol surface, planner, tracing, watch layer, and the analyzer
# itself. Pinned in requirements-dev.txt; skipped with a notice when not
# installed, same contract as ruff above. CI runs the same command.
typecheck:
	@if command -v mypy >/dev/null 2>&1; then mypy --config-file mypy.ini; \
	else echo "typecheck: mypy not installed; skipping (pip install -r requirements-dev.txt)"; fi

clean:
	$(MAKE) -C native clean
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true

image:
	$(MAKE) -f deployments/container/Makefile build-debian
