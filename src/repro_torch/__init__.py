"""PyTorch/CUDA port of the CR-CIM simulator and serving stack.

A second package beside the JAX reference ``repro``: it imports torch,
numpy and the standard library, never JAX and nothing of ``repro``. The
hot path runs hand-written CUDA C++ kernels for Hopper (``csrc/``, built
with ``nvcc`` at first use, see ``kernels/_build.py``); each kernel keeps a
plain PyTorch version that serves CPU tensors and is the yardstick on the
card.

Importing the package turns TF32 off for float32 matmuls and for cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``): the reference computes in
full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (the default) and missing —
    there is no silent fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    return dev
