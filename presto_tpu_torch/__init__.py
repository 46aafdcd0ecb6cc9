"""presto_tpu_torch: the PyTorch/CUDA port of presto_tpu.

A second package beside ``presto_tpu`` (the JAX reference, which stays as it
is). It imports torch and numpy, never jax and nothing of ``presto_tpu``.
Its entry points take an explicit ``device``; the default is ``"cuda"``, and
asking for CUDA where there is none raises instead of running on the CPU.
The hand-written CUDA kernels live in ``kernels/`` and are built at first
use.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on; raises when CUDA is asked
    for and absent (the port never falls back to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


# The lock sanitizer (PRESTO_TPU_TORCH_LOCKSAN=1) replaces threading's
# Lock/RLock/Condition before any module of the port allocates one: the
# engine import below reaches exec/shared_pools, whose pools allocate their
# conditions at import.
from .utils import locksan as _locksan  # noqa: E402

_locksan.install_from_env()

# the reference's package exports of the columnar substrate
from .block import Block, Dictionary, Page, page_from_arrays, page_from_pylists  # noqa: E402,F401

# the plugin function libraries register themselves on import, as the
# reference's do on ``import presto_tpu``
from . import functions  # noqa: E402,F401

# The leak sanitizer (PRESTO_TPU_TORCH_LEAKSAN=1) patches engine classes,
# so it installs once they are importable; nothing it tracks exists before
# the first query. The compile sanitizer (PRESTO_TPU_TORCH_COMPILESAN=1)
# wraps the composition funnel, with the same timing.
from .utils import leaksan as _leaksan  # noqa: E402

_leaksan.install_from_env()

from .utils import compilesan as _compilesan  # noqa: E402

_compilesan.install_from_env()
