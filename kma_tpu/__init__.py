"""kma_tpu — an accelerator re-implementation of the capabilities of KMA.

KMA (k-mer alignment, genomicepidemiology/kma) maps raw sequencing reads
against highly redundant reference databases with a seed-and-extend aligner
and resolves multi-mapping reads with the ConClave voting scheme.

This package re-builds that capability for a JAX device (an NVIDIA GPU;
the CPU backend runs the same code for tests):

- the frozen k-mer index (reference hashmapkma.c) becomes a device-resident
  hash table queried with batched gathers,
- per-read candidate scoring (reference savekmers.c) becomes vectorised
  scans over read batches,
- the banded Needleman-Wunsch extension (reference nw.c) becomes a
  row-scan DP with a suffix max per row (XLA on the CPU, CUDA on the GPU),
- ConClave and consensus assembly (reference conclave.c / assembly.c)
  become segment-sum reductions over candidate tables.

Host-side NumPy reference paths reproduce the reference binary's observable
behaviour bit-for-bit (the parity target is the reference at `-t 1`), and the
JAX paths are validated against them.
"""

import os as _os
import sys as _sys

__version__ = "0.1.0"
KMA_COMPAT_VERSION = "1.5.1"  # reference version we mirror (version.h:20)

#: JAX's persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset:
#: one fixed path (the path is part of the cache key, so a directory that
#: moves never hits).  It becomes the environment default, which jax
#: reads when it is imported and subprocesses inherit.
COMPILE_CACHE = _os.path.join(_os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))), ".cache", "jax")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _os.environ["JAX_COMPILATION_CACHE_DIR"] = COMPILE_CACHE
    if "jax" in _sys.modules:  # imported before this package
        _sys.modules["jax"].config.update("jax_compilation_cache_dir",
                                          COMPILE_CACHE)
