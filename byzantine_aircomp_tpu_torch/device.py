"""Device selection for the port's entry points.

Every entry point (``Trainer``, ``harness.run``, the CLI) runs on CUDA
unless the caller asks for the CPU.  A missing GPU is an error, never a
quiet fall back to the CPU: a CPU run is a correctness check, and a number
taken on it must not pass for a GPU number.
"""

from __future__ import annotations

import torch


def resolve_device(device: str = "cuda") -> torch.device:
    """``"cuda"`` (default) or ``"cpu"`` -> a ``torch.device``.

    Also switches TF32 off for float32 matmuls and convolutions: the JAX
    reference computes in full float32, and TF32 keeps only about three
    decimal digits (cuDNN convolutions default to it).  And it holds cuDNN
    to deterministic algorithms, picked without benchmarking: a conv's
    backward then gives the same bits on a rerun, which a bitwise resume
    of the CNN and ResNet-18 runs needs.
    """
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (CLI: --device cpu) to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return dev
