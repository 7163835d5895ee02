"""sim_a_splat_torch — the PyTorch/CUDA port of ``sim_a_splat_tpu``.

The JAX package stays the reference; every module here keeps the name of its
JAX counterpart so a reader finds each one.  The port imports ``torch`` and
numpy only.  Its compositing kernels are CUDA C++ for Hopper (``csrc/``),
each a forward and a backward: K1, the static background's composite
(``ops/composite.py``); K2, the selected-tile composite of the batched
pushT step (``ops/composite_sel.py``); K3, the moving camera's per-env
composite (``ops/composite_single.py``); K4, the per-env step's merge-free
composite (``ops/composite_pair.py``).  They are built with ``nvcc`` at
first use and loaded through ctypes (``ops/_kernels.py``); every kernel has
a plain PyTorch version beside it that the CPU path and the tests use.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; asking for CUDA without a card raises.

All math is float32.  Float32 matrix products must stay full float32: the
plain compositing versions contract with ``torch.matmul``/``einsum``, and
TF32 would keep only ~3 decimal digits, so importing the package turns TF32
off for both matmul and cuDNN.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if CUDA is asked for and
    there is no card (the port never carries on quietly on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was asked for but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain CPU path")
    return dev
