# Reference-equivalent make targets (reference: Makefile:12-42).
# The compute core is JAX/Pallas (no build step); `make` builds the native
# host library, `make test_launch` runs the reference golden test.

PYTHON ?= python3
DATA := stringdecomposer_tpu/test_data

.PHONY: all test test_tpu test_gpu test_launch install uninstall clean

all:
	$(MAKE) -C stringdecomposer_tpu/runtime/native

test:
	$(PYTHON) -m pytest tests/ -q -m "not slow"

# one-command hardware parity suite: Mosaic compile path (interpret=False
# Pallas kernels vs oracles) + bench.py's TSV byte-gate. Needs a real TPU.
test_tpu:
	SDTPU_TESTS_ON_TPU=1 $(PYTHON) -m pytest tests/ -q -m tpu
	$(PYTHON) bench.py

# the PyTorch / CUDA port on one GPU: builds the kernels, checks them against
# their plain twins and the fixtures, and runs the golden and 1.6 Mbp paths
test_gpu:
	$(PYTHON) chip_smoke.py

test_launch:
	rm -rf /tmp/sd_tpu_test && \
	$(PYTHON) -m stringdecomposer_tpu $(DATA)/read.fa \
	  $(DATA)/DXZ1_star_monomers.fa -o /tmp/sd_tpu_test --second-best && \
	grep -q "Thank you for using StringDecomposer!" /tmp/sd_tpu_test/stringdecomposer.log && \
	diff -q /tmp/sd_tpu_test/final_decomposition.tsv $(DATA)/final_decomposition_fc89af8.tsv && \
	echo "test_launch: OK (byte-identical to the reference golden TSV)"

install:
	$(PYTHON) -m pip install . --no-build-isolation

uninstall:
	$(PYTHON) -m pip uninstall -y stringdecomposer-tpu

clean:
	rm -f stringdecomposer_tpu/runtime/native/libsdnative.so
	rm -rf stringdecomposer_tpu_torch/build
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
