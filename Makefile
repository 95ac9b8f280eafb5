# One-command verification gate (SURVEY.md §7 step 8 without CI infra):
#   make check  = native build + CPU test suite + native TSan stress
#                 + the bench trivial-jit device probe.
# Exits nonzero on any code failure.  The device probe is environmental (no
# accelerator, or one that does not answer): a failed probe prints a
# warning and passes unless MELONIX_CHECK_STRICT=1.  The accelerator itself
# is checked end to end by `python chip_smoke.py`.

PYTHON ?= python

.PHONY: check native test tsan probe clean

check: native test tsan probe
	@echo "make check: ALL GATES PASSED"

native:
	$(MAKE) -C native

test:
	$(PYTHON) -m pytest tests/ -x -q

tsan:
	$(MAKE) -C native tsan-check

# Trivial-jit probe on the default backend (the accelerator when attached).
# bench._probe_service is the same gate bench.py puts in front of every
# on-chip measurement.
probe:
	@$(PYTHON) -c "import bench; ok = bench._probe_service(120.0); \
	    import os, sys; \
	    print('device probe:', 'ok' if ok else 'STALLED'); \
	    sys.exit(0 if (ok or not os.environ.get('MELONIX_CHECK_STRICT')) else 1)"

clean:
	$(MAKE) -C native clean
