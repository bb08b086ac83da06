"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Same subpackage names as the JAX package (``adaptive``, ``api``, ``chaos``,
``ckpt``, ``configs``, ``core``, ``data``, ``fleet``, ``kernels``,
``models``, ``parallel``, ``planning``, ``runtime``, ``serving``,
``streaming``, ``sweep``), so every module has one counterpart there.
The port imports ``torch`` and ``numpy`` only.

Device policy: every entry point takes ``device=None``, which resolves to
``"cuda"``; with no CUDA device it raises instead of quietly running on
the CPU.  Callers that want the CPU (the tests) pass ``device="cpu"``.

Precision: the stream-sampling system computes in f32, as the reference
does; the LM models (``models``, ``serving``) compute in their config's
activation type, bf16 by default, with f32 scores, norms and logits where
the reference keeps them.  TF32 is switched off for matmuls and cuDNN:
the reference's sums are f32, and TF32 keeps about three decimal digits,
which would break the f32 tolerance class the port is held to.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for but missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


__all__ = ["resolve_device"]
