"""Which implementation of the device kernels this process runs.

One rule, taken from the JAX platform alone: ``gpu`` runs the
hand-written kernels (ops/scan_kernel.py through Pallas/Triton,
ops/nw_kernel.py through CUDA), ``cpu`` runs their plain jax.numpy/lax
versions, and any other platform is refused.  No environment variable
chooses a kernel.
"""

from __future__ import annotations

KERNELS = {"gpu": True, "cpu": False}


def use_kernels() -> bool:
    """True on the GPU, False on the CPU; raises on any other platform."""
    import jax

    p = jax.default_backend()
    if p not in KERNELS:
        raise RuntimeError("kma_tpu has no device implementation for "
                           "JAX platform %r (supported: gpu, cpu)" % p)
    return KERNELS[p]
