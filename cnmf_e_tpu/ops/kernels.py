"""Which implementation each kernel-backed op runs.

Two ops have a hand-written Pallas kernel beside their plain XLA form:

* ``"hals"``  — the multi-sweep Gauss-Seidel HALS solve
  (:mod:`cnmf_e_tpu.ops.pallas_hals` vs the blocked loops in
  :mod:`cnmf_e_tpu.ops.hals`);
* ``"oasis"`` — the OASIS AR(1) event loop
  (:mod:`cnmf_e_tpu.ops.pallas_oasis` vs the vmapped ``while_loop`` forms
  in :mod:`cnmf_e_tpu.ops.oasis`).

Both kernels are written for the GPU through Pallas's Triton route, so
they run where the backend is a GPU; elsewhere (the CPU tests) the XLA
form runs, and the tests reach the kernels in interpret mode directly.
A caller under a device mesh gets the XLA form: a ``pallas_call`` is
opaque to the SPMD partitioner. The choice never depends on how many
devices the process sees.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

KERNEL_OPS = ("hals", "oasis")
PALLAS = "pallas-triton"
XLA = "xla"


def choose(op: str, *, mesh=None, backend: Optional[str] = None) -> str:
    """Return :data:`PALLAS` or :data:`XLA` for ``op``.

    ``mesh``: the caller's device mesh, if it runs sharded.
    ``backend``: defaults to ``jax.default_backend()``.
    """
    if op not in KERNEL_OPS:
        raise ValueError(f"unknown kernel op {op!r}")
    if mesh is not None:
        return XLA
    backend = backend or jax.default_backend()
    return PALLAS if backend == "gpu" else XLA


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def hals_layout(K: int, block: int) -> Tuple[int, int]:
    """Padded shapes of the HALS kernel for ``K`` neurons.

    Returns ``(KC, Kp)``: the chunk of the K axis each residual
    ``pl.dot`` contracts, and K padded to a multiple of that chunk and to
    at least one step of ``block`` rows. Triton blocks are powers of two
    and a dot needs every side >= 16, so ``block`` must be a power of two
    >= 16 (a step schedule built for it fixes the row windows), and K pads
    to the next power of two up to 128 and to a multiple of 128 beyond.
    """
    if block < 16 or block != _pow2(block):
        raise ValueError(f"HALS kernel block must be a power of two >= 16, "
                         f"got {block}")
    KC = min(128, max(16, _pow2(K)))
    Kp = -(-max(K, block) // KC) * KC
    return KC, Kp
